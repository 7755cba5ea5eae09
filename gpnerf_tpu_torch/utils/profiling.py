"""Profiling and tracing (gpnerf_tpu/utils/profiling.py).

The reference's instrumentation is per-stage wall timing in the demo
renderer (`time_slots`, a CUDA synchronize before each reading) and the
metric logger's peak device memory. Here:

  * `span`: a named range of the program (context manager or decorator)
    over `torch.profiler.record_function`, entered only while a profiler
    records, so it lands in the profiler's trace beside the kernels it
    launches; off, it costs one flag check. The port's spans, each named
    `gpnerf.<layer>`: `gpnerf.upload` (render/base.py `batch_to_device`),
    `gpnerf.render` (render/demo.py `Renderer.render_demo`) around
    `gpnerf.encoder`, `gpnerf.frame_stage`, `gpnerf.ray_pipeline` (around
    `gpnerf.point_stages`) and `gpnerf.assemble`, `gpnerf.download`
    (`pred_img_hwc`), and train/step.py's `gpnerf.train.forward`,
    `gpnerf.train.loss`, `gpnerf.train.backward`,
    `gpnerf.train.optimizer`;
  * `count` / `counters` / `reset_counters`: a process-wide registry of
    named sums, recorded only while a profiler records: `renders`,
    `upload_bytes`, `point_slots`, `kernel_fetched_slots` (the P of each
    launch of the point-stage kernel, which fetches its own rows,
    ops/point_stages.py; host numbers) and `colored_points` (a 0-d device tensor kept by
    reference and summed when `counters` is read, so counting adds no
    launch and no sync);
  * `trace`: a `torch.profiler` context that writes a Chrome trace;
  * `kernel_table`: a finished profile's time by kernel, largest first
    (tools/trace_demo_torch.py, chip_smoke.py `profile_render`);
  * `device_memory_stats`: the caching allocator's live and peak bytes and
    the card's capacity.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading

import torch


def recording():
    """Whether a torch profiler is recording (the flag it sets on start
    and clears on stop)."""
    return torch.autograd.profiler._is_profiler_enabled


class span:
    """`with span(name):` or `@span(name)`: the range `name` in the
    profiler's trace while one records; nothing otherwise. Spans on one
    thread nest as the calls do."""

    __slots__ = ("name", "_rf")

    def __init__(self, name):
        self.name = name
        self._rf = None

    def __enter__(self):
        if recording():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped


_counts = {}  # name -> [host sum, [0-d device tensors]]
_counts_lock = threading.Lock()


def count(name, value):
    """Add `value` to the counter `name` while a profiler records: a host
    number is added, a tensor (0-d, on any device) is kept and summed when
    `counters` is read."""
    if not recording():
        return
    with _counts_lock:
        slot = _counts.setdefault(name, [0, []])
        if isinstance(value, torch.Tensor):
            slot[1].append(value.detach())
        else:
            slot[0] += value


def counters():
    """{name: total} of every counter recorded since the last
    `reset_counters` (reading the kept tensors waits for their device)."""
    with _counts_lock:
        items = [(k, h, list(ts)) for k, (h, ts) in _counts.items()]
    return {k: h + sum(t.item() for t in ts) for k, h, ts in items}


def reset_counters():
    """Forget every counter."""
    with _counts_lock:
        _counts.clear()


@contextlib.contextmanager
def trace(log_dir="gpnerf_trace"):
    """Profile the body (CPU, and CUDA when a card is present) and write a
    Chrome trace, `trace_<pid>.json`, into `log_dir`; yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def kernel_table(prof, device_type="cuda"):
    """[(name, total ms, launches)] of a finished `torch.profiler` run,
    largest time first: on a card the device-side events (each kernel by
    its own device time, no host op); on the CPU, which has no device
    events, each op by its self CPU time."""
    from torch.autograd import DeviceType

    if device_type == "cuda":
        rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    else:
        rows = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def device_memory_stats(device=None):
    """{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"} of a CUDA
    device (the current one by default, the CPU without a card); {} for the
    CPU, which keeps no such statistics, as the JAX package returns for a
    device without them."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    _, total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
    }
