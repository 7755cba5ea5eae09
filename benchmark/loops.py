"""The general generator: it reads a traffic file and drives the system
with it. A traffic file names its loop and holds its parameters:

  * `views`: a closed loop of one client; each request is one novel view,
    timed from its host batch to its image on the host: the batch's upload
    (`render/base.py` batch_to_device), the program's `render_demo_fn()`,
    and the image's download (`render/demo.py` pred_img_hwc). The
    requests cycle, in a seeded order, through a pool of `pool` items
    built in set-up (benchmark/pool.py);
  * `train_steps`: a closed loop of optimizer steps (`train/step.py`
    train_step), cycling through `batches` train batches built and
    uploaded in set-up, each with its seeded jitter draws.

The programs are those the configuration names (benchmark/system.py).

Each loop's set-up builds its inputs and the program, warms every shape
the window uses, and, for training, drives the first `check_steps` steps
whose results the reference checks. `window` then runs the loop for a
number of seconds, or for one traced stretch under the profiler's spans.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import check, pool, system

REQUEST, STEP = "bench.request", "bench.step"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span(name, on):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class Views:
    unit = REQUEST

    def __init__(self, conf, traffic, seed, device):
        self.conf, self.traffic, self.seed, self.device = conf, traffic, seed, device
        self.cfg = conf["cfg"]

    def setup(self):
        n = self.traffic["pool"]
        self.scene = pool.new_scene(self.cfg)
        self.poses, self.cams = pool.view_items(self.seed, n, pool.img_hw(self.cfg))
        ds = pool.make_dataset(system.data_layer(), self.scene, self.poses, self.cams, "test",
                               self.cfg)
        self.host = pool.build_batches(ds, self.seed, range(n), pool.VIEW_TAG)
        self.order = pool.request_order(self.seed, n)
        self.render = system.views_program(self.conf, self.device)
        self.fn = self.render.render_demo_fn()
        self.last = {}
        self.served = 0
        for k in range(self.traffic["warm_requests"]):
            self._request(self.order[k % n])
        _sync(self.device)

    def _request(self, i):
        from gpnerf_tpu_torch.render.demo import pred_img_hwc

        image = pred_img_hwc(self.fn(system.to_device(self.host[i], self.device)))
        self.last[int(i)] = image  # the answer, downloaded to the host

    def window(self, seconds, spans=False):
        """Closed loop for `seconds`; returns the request latencies (s),
        the items served in order, and the window's length (s)."""
        n = len(self.host)
        lat, items = [], []
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while time.perf_counter() < deadline:
            i = self.order[self.served % n]
            t0 = time.perf_counter()
            with _span(REQUEST, spans):
                self._request(i)
            lat.append(time.perf_counter() - t0)
            items.append(int(i))
            self.served += 1
        t_end = time.perf_counter()
        return {"latencies": lat, "items": items, "seconds": t_end - t_start, "start": t_start}

    @staticmethod
    def end_to_end(w):
        lat = np.asarray(w["latencies"])
        return {"frames_per_s": len(lat) / w["seconds"],
                "frame_p95_ms": float(np.percentile(lat, 95) * 1e3)}

    def answers(self, items):
        """The program's last image for each of `items`."""
        return {i: self.last[i] for i in items}

    def release(self):
        del self.render, self.fn


class TrainSteps:
    unit = STEP

    def __init__(self, conf, traffic, seed, device):
        self.conf, self.traffic, self.seed, self.device = conf, traffic, seed, device
        self.cfg = conf["cfg"]

    def t_rands(self, n):
        """The stratified-sampling jitter of each train batch, drawn from
        the seed on the device."""
        t = self.cfg["train"]
        g = torch.Generator(device=self.device)
        g.manual_seed(int(np.random.SeedSequence(pool.seed_words(self.seed, 4))
                          .generate_state(1, np.uint64)[0] >> 1))
        return [torch.rand((t["n_rays"], t["n_samples"]), generator=g, device=self.device)
                for _ in range(n)]

    def setup(self):
        n = self.traffic["batches"]
        self.scene = pool.new_scene(self.cfg)
        self.poses, self.cams = pool.train_items(self.seed, n, pool.img_hw(self.cfg))
        ds = pool.make_dataset(system.data_layer(), self.scene, self.poses, self.cams, "train",
                               self.cfg)
        self.batches = [system.to_device(b, self.device)
                        for b in pool.build_batches(ds, self.seed, range(n), pool.TRAIN_TAG)]
        self.jitter = self.t_rands(n)
        self.step = system.TrainStep(self.conf, self.device)
        self.done = 0
        self.readings = self._checked_steps(self.traffic["check_steps"])

    def _one(self, spans=False):
        k = self.done % len(self.batches)
        with _span(STEP, spans):
            metrics, _ = self.step(self.batches[k], self.jitter[k])
        self.done += 1
        return metrics

    def _checked_steps(self, steps):
        """The first `steps` steps, through the window's own call, with
        what the reference checks: each loss, each leaf's first gradient
        (Adam's first moment over 1 - beta1 after step 1, beta1 the
        program's optimizer's) and change."""
        beta1 = self.step.optimizer.param_groups[0]["betas"][0]
        params = dict(self.step.render.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        losses, grad1 = [], None
        for k in range(steps):
            losses.append(self._one()["loss"].item())
            if k == 0:
                st = self.step.optimizer.state
                grad1 = {n: float((st[p]["exp_avg"] / (1 - beta1)).double().norm())
                         if p in st else 0.0 for n, p in params.items()}
        change = check.leaf_norms((n, p - start[n]) for n, p in params.items())
        _sync(self.device)
        return {"losses": losses, "grad1": grad1, "change": change}

    def window(self, seconds, spans=False):
        t_start = time.perf_counter()
        deadline = t_start + seconds
        first = self.done
        while time.perf_counter() < deadline:
            self._one(spans)
        _sync(self.device)
        t_end = time.perf_counter()
        return {"steps": self.done - first, "first": first, "seconds": t_end - t_start,
                "start": t_start}

    @staticmethod
    def end_to_end(w):
        return {"train_step_ms": w["seconds"] / w["steps"] * 1e3}

    def release(self):
        del self.step, self.batches


LOOPS = {"views": Views, "train_steps": TrainSteps}
