"""Readings of the program's own spans and counters in a traced window.

The port opens a `record_function` range named `gpnerf.<layer>` around each
of its layers while a profiler records (gpnerf_tpu_torch/utils/profiling.py
`span`), and sums named counters meanwhile (`count`, `counters`). The
helpers here read them over a `benchmark.trace.Trace`'s events: a span's
host time, its self time, the device time of the kernels launched inside
it and not inside a span nested in it, and the device's idle time while
the host is inside it. A span or counter the program lacks (a program older
than them) reads None, and nothing raises.

A launch belongs to the innermost span under way when it was made, whatever
thread made it (the autograd engine launches the backward from a thread of
its own); a kernel, to its launch through the trace's correlation id.
"""

from __future__ import annotations

import bisect

from benchmark.trace import LAUNCHES, _union

ANNOTATION = "user_annotation"
RENDER = "gpnerf.render"


def _annotations(tr):
    """The window's spans as (start, end, name) in the order they open (µs)."""
    cache = getattr(tr, "_span_cache", None)
    if cache is None:
        # an enclosing span before a nested one that opens at the same time
        cache = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in tr._host
                        if e.get("cat") == ANNOTATION), key=lambda x: (x[0], -x[1]))
        tr._span_cache = cache
    return cache


def intervals(tr, name):
    """[(start, end)] of the spans `name` in the window (µs)."""
    return [(s, e) for s, e, n in _annotations(tr) if n == name]


def host_ms(tr, name):
    """Milliseconds the host spent inside the spans `name`; None without one."""
    iv = intervals(tr, name)
    return sum(e - s for s, e in iv) / 1e3 if iv else None


def self_ms(tr, name):
    """`host_ms` less the part of each span that spans nested in it cover."""
    iv = intervals(tr, name)
    if not iv:
        return None
    spans = _annotations(tr)
    total = 0.0
    for s, e in iv:
        inner = _union([(a, b) for a, b, n in spans
                        if s <= a and b <= e and (a, b, n) != (s, e, name)])
        total += (e - s) - sum(b - a for a, b in inner)
    return total / 1e3


def _device_by_span(tr):
    """{span name: device µs of the kernels whose launch it holds innermost}.
    One sweep over the launches in time order with the stack of open spans
    (the program's spans nest: they are opened on one thread)."""
    cache = getattr(tr, "_device_by_span_cache", None)
    if cache is not None:
        return cache
    spans = _annotations(tr)
    launches = sorted((e["ts"], e.get("args", {}).get("correlation")) for e in tr._host
                      if e["name"] in LAUNCHES)
    owner, stack, j = {}, [], 0
    for t, corr in launches:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack and corr is not None:
            owner[corr] = stack[-1][2]
    cache = {}
    for e in tr._dev:
        if e.get("cat") == "kernel":
            n = owner.get(e.get("args", {}).get("correlation"))
            if n is not None:
                cache[n] = cache.get(n, 0.0) + e["dur"]
    tr._device_by_span_cache = cache
    return cache


def device_ms(tr, name):
    """Device milliseconds of the kernels launched inside the spans `name`
    and inside no span nested in them; None without such a span."""
    if not intervals(tr, name):
        return None
    return _device_by_span(tr).get(name, 0.0) / 1e3


def idle_ms(tr, name):
    """Milliseconds in which the device ran nothing while the host was
    inside the spans `name`; None without one."""
    iv = intervals(tr, name)
    if not iv:
        return None
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in tr._dev])
    starts = [s for s, _ in busy]
    idle = 0.0
    for s, e in iv:
        idle += e - s
        k = max(0, bisect.bisect_right(starts, s) - 1)
        while k < len(busy) and busy[k][0] < e:
            idle -= max(0.0, min(busy[k][1], e) - max(busy[k][0], s))
            k += 1
    return idle / 1e3


def counters():
    """The program's counters over the traced window, or None where the
    program keeps none."""
    try:
        from gpnerf_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return read() if read is not None else None


def requests(tr):
    """The traced requests, where the program rendered once for each
    (its `renders` counter and its `gpnerf.render` spans both equal the
    `bench.request` spans); else None."""
    c = counters()
    n = tr.units
    if not n or c is None or c.get("renders") != n or len(intervals(tr, RENDER)) != n:
        return None
    return n


def per_request(tr, value):
    """`value` over the traced requests (`requests`); None where either is."""
    n = requests(tr)
    return value / n if n and value is not None else None


def step_host_ms(tr, name):
    """Host milliseconds per traced step inside the span `name`, where it
    opened once in each step; else None."""
    n = tr.units
    if not n or len(intervals(tr, name)) != n:
        return None
    return host_ms(tr, name) / n
