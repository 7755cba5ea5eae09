"""Profiling and tracing (gpnerf_tpu/utils/profiling.py).

The reference's instrumentation is per-stage wall timing in the demo
renderer (`time_slots`, a CUDA synchronize before each reading) and the
metric logger's peak device memory. Here:

  * `StageTimer`: wall timing with the same `time_slots` dict; `stop`
    synchronizes the devices of the CUDA tensors it is given, so their
    work is charged to the stage that queued it;
  * `trace`: a `torch.profiler` context that writes a Chrome trace;
  * `kernel_table`: a finished profile's time by kernel, largest first
    (tools/trace_demo_torch.py, chip_smoke.py `profile_render`);
  * `device_memory_stats`: the caching allocator's live and peak bytes and
    the card's capacity.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class StageTimer:
    """Accumulates named stage durations in seconds (`time_slots`)."""

    def __init__(self):
        self.time_slots = {}
        self._t0 = None

    def start(self):
        self._t0 = time.time()

    def stop(self, name, *sync_on):
        """Charge the time since the last start/stop to `name`, after the
        devices of the CUDA tensors in `sync_on` finish their work."""
        for dev in {x.device for x in sync_on if isinstance(x, torch.Tensor) and x.is_cuda}:
            torch.cuda.synchronize(dev)
        self.time_slots[name] = self.time_slots.get(name, 0.0) + (time.time() - self._t0)
        self._t0 = time.time()


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
