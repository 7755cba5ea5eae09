"""The traced window: a `torch.profiler` run over the harness's spans, read
back from its Chrome trace and reduced to what the per-layer readers take.

Spans are `record_function` ranges: the harness opens `bench.window`
around the traced window and one `bench.request` or `bench.step` per unit
of work; the program opens its own inside them (benchmark/spans.py reads
those). `Trace` holds, over the window:
  * the device activity (kernels, copies, fills) and its union, `busy_s`;
  * the host's runtime calls: kernel launches and blocking calls;
  * `device_ops`, the kernels that took most time (the aggregation of
    gpnerf_tpu_torch/utils/profiling.py `kernel_table` at commit ffa1347,
    on the trace's events), and `idle_gaps`, the device's idle time by the
    innermost host call under way when the gap began.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
LAUNCHES = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel"}
# calls that block the host until the device has caught up: stream, device
# and event synchronisation, and the synchronous copies
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize", "cudaMemcpy",
         "cuMemcpyDtoH_v2", "cuMemcpyHtoD_v2", "cuMemcpy"}
WINDOW = "bench.window"
TOP = 10
NAME_CHARS = 160


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """A traced window's events (see the module docstring); times in
    seconds. `unit` is the span name of one unit of work."""

    def __init__(self, events, unit):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
        if len(win) != 1:
            raise RuntimeError(f"the trace holds {len(win)} {WINDOW} spans, not 1")
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        self.window_s = (w1 - w0) / 1e6

        def inside(e):
            return w0 <= e["ts"] and e["ts"] + e["dur"] <= w1

        host = [e for e in xs if e.get("cat") in HOST_CATS and inside(e)]
        dev = [e for e in xs if e.get("cat") in DEVICE_CATS
               and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
        self.units = sum(1 for e in host if e["cat"] == "user_annotation" and e["name"] == unit)
        self.launches = sum(1 for e in host if e["name"] in LAUNCHES)
        self.syncs = sum(1 for e in host if e["name"] in SYNCS)
        busy = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev])
        self.busy_s = sum(e - s for s, e in busy) / 1e6
        self._dev, self._host = dev, host

        by_name = collections.defaultdict(float)
        for e in dev:
            if e["cat"] == "kernel":
                by_name[e["name"]] += e["dur"] / 1e6
        self.kernel_s = dict(by_name)
        self.device_ops = [[k[:NAME_CHARS], v] for k, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
        self.idle_gaps = self._idle_gaps(busy, w0, w1)

    def kernel_time_s(self, fragment):
        """Device seconds of the kernels whose name holds `fragment`."""
        return sum(v for k, v in self.kernel_s.items() if fragment in k)

    def _idle_gaps(self, busy, w0, w1):
        edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self._host, key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        total = collections.defaultdict(float)
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
            total[self._host_call(host, starts, s)] += (e - s) / 1e6
        return [[k[:NAME_CHARS], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    @staticmethod
    def _host_call(host, starts, t, scan=5000):
        """The innermost host event under way at time t."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - scan), -1):
            e = host[j]
            if e["ts"] + e["dur"] >= t:
                return e["name"]
        return "host (no traced call)"


def traced(fn, unit):
    """Run `fn` under the profiler inside a `bench.window` span; returns
    (fn's result, Trace). The Chrome trace goes to a temporary file that
    is read back and deleted."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, Trace(events, unit)
