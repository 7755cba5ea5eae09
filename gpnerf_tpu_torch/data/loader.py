"""Samplers and the data loader (gpnerf_tpu/data/loader.py; reference
samplers.py:23-207): SequentialSampler, RandomSampler (a seeded numpy
permutation, the JAX package's index order for the same seed),
FrameSampler (every 30th frame x all test cams), BatchSampler,
ImageSizeBatchSampler (a random 32-aligned image size per batch drawn from
np.random, in the JAX package's order; the datasets read the index of each
(index, h, w) and ignore the size, as the reference's do),
IterationBasedBatchSampler (ep_iter iterations per epoch),
DistributedSampler (each rank's contiguous shard of an epoch-seeded
permutation, for the data-parallel trainer), and a loader that yields one
frame (a dict of numpy arrays) per index batch of size 1, a list of frames
per larger batch."""

from __future__ import annotations

import math
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


class DistributedSampler:
    """Rank `rank`'s contiguous shard of `num_replicas` (samplers.py:86-142):
    the indices, shuffled by `np.random.default_rng(epoch)` when `shuffle`,
    padded by wrapping around to a multiple of `num_replicas`."""

    def __init__(self, dataset, num_replicas, rank, shuffle=True):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas
        self.shuffle = shuffle

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.default_rng(self.epoch).permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - len(indices)]
        assert len(indices) == self.total_size
        offset = self.num_samples * self.rank
        return iter(indices[offset: offset + self.num_samples])

    def __len__(self):
        return self.num_samples

    def set_epoch(self, epoch):
        self.epoch = epoch


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


class ImageSizeBatchSampler:
    """Batches of (index, h, w): one random size per batch, h and w drawn
    in [min, max] and rounded up past a multiple of 32 (samplers.py:23-58);
    strategy "origin" gives (-1, -1)."""

    def __init__(self, sampler, batch_size, drop_last, sampler_meta):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.strategy = sampler_meta["strategy"]
        self.hmin, self.wmin = sampler_meta["min_hw"]
        self.hmax, self.wmax = sampler_meta["max_hw"]
        self.divisor = 32

    def generate_height_width(self):
        if self.strategy == "origin":
            return -1, -1
        h = np.random.randint(self.hmin, self.hmax + 1)
        w = np.random.randint(self.wmin, self.wmax + 1)
        return (h | (self.divisor - 1)) + 1, (w | (self.divisor - 1)) + 1

    def __iter__(self):
        batch = []
        h, w = self.generate_height_width()
        for idx in self.sampler:
            batch.append((idx, h, w))
            if len(batch) == self.batch_size:
                h, w = self.generate_height_width()
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


def make_data_sampler(cfg, dataset, is_distributed, is_train, *, num_replicas=1, rank=0,
                      seed=None):
    """The index sampler of the train or test split (samplers.py:167-182):
    FrameSampler for a FrameSampler test split, else DistributedSampler
    under `is_distributed`, else a shuffle seeded by `seed` or the order."""
    split = cfg.dataset.train if is_train else cfg.dataset.test
    if not is_train and split.sampler == "FrameSampler":
        return FrameSampler(dataset)
    if is_distributed:
        return DistributedSampler(dataset, num_replicas, rank, shuffle=split.shuffle)
    return RandomSampler(dataset, seed) if split.shuffle else SequentialSampler(dataset)


def build_batchsampler(cfg, dataset, batch_size, is_train, seed=None, *, is_distributed=False,
                       num_replicas=1, rank=0):
    """The batch sampler of the train or test split (reference
    samplers.py:167-207): "default" or "image_size" (another name raises
    ValueError, as the JAX package's does) over `make_data_sampler`; `seed`
    seeds the shuffle of one process, `is_distributed` shards the split
    over `num_replicas` ranks."""
    split = cfg.dataset.train if is_train else cfg.dataset.test
    sampler = make_data_sampler(cfg, dataset, is_distributed, is_train,
                                num_replicas=num_replicas, rank=rank, seed=seed)
    if isinstance(sampler, FrameSampler):
        return sampler
    if split.batch_sampler == "default":
        batch_sampler = BatchSampler(sampler, batch_size, split.drop_last)
    elif split.batch_sampler == "image_size":
        batch_sampler = ImageSizeBatchSampler(sampler, batch_size, split.drop_last,
                                              split.sampler_meta)
    else:
        raise ValueError(split.batch_sampler)
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
