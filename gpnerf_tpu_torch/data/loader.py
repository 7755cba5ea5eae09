"""Samplers and the data loader (gpnerf_tpu/data/loader.py; reference
samplers.py:61-207): SequentialSampler, RandomSampler (a seeded numpy
permutation, the JAX package's index order for the same seed),
FrameSampler (every 30th frame x all test cams), BatchSampler,
IterationBasedBatchSampler (ep_iter iterations per epoch), and a loader
that yields one frame (a dict of numpy arrays) per index batch of size 1.

The port trains on one device: the distributed sampler and the
`image_size` batch sampler (unused by the shipped configs) are not ported;
`build_batchsampler` raises for the latter."""

from __future__ import annotations

import multiprocessing as mp

import numpy as np


class SequentialSampler:
    def __init__(self, dataset):
        self.n = len(dataset)

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n


class RandomSampler:
    def __init__(self, dataset, seed=None):
        self.n = len(dataset)
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return iter(self.rng.permutation(self.n).tolist())

    def __len__(self):
        return self.n


class FrameSampler:
    """Test time: every `frame_stride`-th frame x all test cams."""

    def __init__(self, dataset, frame_stride=30):
        ni = len(dataset) // dataset.num_cams
        inds = np.arange(0, ni * dataset.num_cams).reshape(ni, -1)[::frame_stride]
        self.inds = inds.ravel()

    def __iter__(self):
        return iter(self.inds.tolist())

    def __len__(self):
        return len(self.inds)


class BatchSampler:
    def __init__(self, sampler, batch_size, drop_last):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return len(self.sampler) // self.batch_size
        return (len(self.sampler) + self.batch_size - 1) // self.batch_size


class IterationBasedBatchSampler:
    """Exactly `num_iterations` batches per pass, re-walking the batch
    sampler as often as needed."""

    def __init__(self, batch_sampler, num_iterations, start_iter=0):
        self.batch_sampler = batch_sampler
        self.sampler = batch_sampler.sampler
        self.num_iterations = num_iterations
        self.start_iter = start_iter

    def __iter__(self):
        iteration = self.start_iter
        while iteration <= self.num_iterations:
            for batch in self.batch_sampler:
                iteration += 1
                if iteration > self.num_iterations:
                    break
                yield batch

    def __len__(self):
        return self.num_iterations


def build_batchsampler(cfg, dataset, batch_size, is_train, seed=None):
    """The batch sampler of the train or test split (reference
    samplers.py:167-207); `seed` seeds the shuffle."""
    split = cfg.dataset.train if is_train else cfg.dataset.test
    if not is_train and split.sampler == "FrameSampler":
        return FrameSampler(dataset)
    if split.batch_sampler != "default":
        raise NotImplementedError(
            f"dataset.{'train' if is_train else 'test'}.batch_sampler="
            f"{split.batch_sampler!r}: the port has the default batch sampler only")
    sampler = RandomSampler(dataset, seed) if split.shuffle else SequentialSampler(dataset)
    batch_sampler = BatchSampler(sampler, batch_size, split.drop_last)
    if is_train and cfg.train.ep_iter != -1:
        batch_sampler = IterationBasedBatchSampler(batch_sampler, cfg.train.ep_iter)
    return batch_sampler


# worker-process state of DataLoader(num_workers > 0): each spawned worker
# receives the dataset once, through the pool's initializer
_WORKER_DATASET = []


def _init_worker(dataset):
    _WORKER_DATASET[:] = [dataset]


def _fetch(dataset, idx):
    if isinstance(idx, list):
        return dataset[idx[0]] if len(idx) == 1 else [dataset[i] for i in idx]
    return dataset[idx]


def _worker_fetch(idx):
    return _fetch(_WORKER_DATASET[0], idx)


class DataLoader:
    """Yields one frame per index batch (a batch of one index is
    unwrapped). `num_workers` > 0: a pool of spawned worker processes runs
    `__getitem__` in parallel and results stream back in order; else, with
    `prefetch` > 0, one background thread prepares the next frames; both
    zero: synchronous. `close()` ends the pool."""

    def __init__(self, dataset, batch_sampler, prefetch=2, num_workers=0):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.prefetch = prefetch
        self.num_workers = int(num_workers)
        self._pool = None

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __iter__(self):
        if self.num_workers > 0:
            if self._pool is None:
                ctx = mp.get_context("spawn")
                self._pool = ctx.Pool(self.num_workers, initializer=_init_worker,
                                      initargs=(self.dataset,))
            yield from self._pool.imap(_worker_fetch, iter(self.batch_sampler))
            return
        if not self.prefetch:
            for idx in self.batch_sampler:
                yield _fetch(self.dataset, idx)
            return
        import queue
        import threading

        q = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for idx in self.batch_sampler:
                    q.put(_fetch(self.dataset, idx))
            finally:
                q.put(stop)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item

    def __len__(self):
        return len(self.batch_sampler)


def data_loop(data_loader):
    """Loop an iterable forever (reference BaseTrainer.py:22-28)."""
    while True:
        yield from data_loader
