"""Bytes and FLOPs of the port's program: the counterpart of XLA's
`cost_analysis()` as the JAX package's tools/roofline.py and bench.py use
it, and the stop-stage roofline ladder of tools/roofline.py.

`counting(device)` is a context manager over a TorchDispatchMode. It adds
up, for each aten op whose result lives on `device`, the bytes of its
operands read once and of its results written once, and its FLOPs from
`torch.utils.flop_counter`'s registry (matmuls, convolutions, attention; two
per multiply-add; elementwise ops count none, where XLA counts one per
element). The counting rules:

  * view and alias ops (`func.is_view`, `detach`, `alias`, `expand`,
    `as_strided`, `_unsafe_view`, `lift_fresh`) cost 0, and so do `empty`
    and its kin; the `new_*` and `*_like` constructors, `fill_` and `zero_`
    write their result and read nothing, `copy_` reads its source and
    writes its destination;
  * a tensor counts its distinct elements: a broadcast (stride 0) dimension
    is read once;
  * a gather counts the rows it reads, not the table it reads from:
    `index`, `index_select`, `gather`, `embedding` and `take_along_dim`
    count their indices, the output's bytes once as rows read and once more
    as the output written;
  * a scatter counts the same way: `index_put_`, `scatter_`,
    `scatter_add_`, `scatter_reduce_` and `index_add_` count their indices,
    their source, and the destination elements they touch, read and
    written (a boolean mask touches its true entries); the out-of-place
    variants also read and write the whole destination;
  * a copy between the host and the card (`_to_copy`, `copy_` across
    devices, `.item()`) is kept apart under `transfer_bytes` and is not
    device traffic; an op whose result lives elsewhere than `device` (a host
    op during a card render) is left out and counted under `host_ops`.

The hand-written kernels are launched through ctypes, which a dispatch mode
does not see. Each wrapper therefore declares its cost with `note_kernel`:
the kernel's operands read once and its results written once (ops modules'
`cost`), as XLA counts a Pallas custom call by its operand and result
bytes. Counting is suspended inside it, so the plain version that stands in
for a kernel on the CPU counts the same declared cost and none of its own
ops, and a frame counts the same on the CPU as on the card. A plain stand-in
for a library call the CPU lacks (ops/sparse_conv.py's bf16 product with a
float32 result) declares that call's cost the same way.

`ladder(render, frames, feats)` runs tools/roofline.py's ladder on the
port: every prefix of render/demo.py STOP_STAGES and the whole render, op by
op, counted once on frame 0 and timed over the frames, then the configured
(fused) program. The card's published peaks are `HBM_BYTES_PER_S` and
`PEAK_FLOP_PER_S`, keyed by `torch.cuda.get_device_name`.
"""

from __future__ import annotations

import collections
import contextlib
import math
import statistics
import threading
import time

import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode

H100 = "NVIDIA H100 80GB HBM3"
# NVIDIA's data sheet, H100 SXM at its 700 W limit: HBM3 bandwidth, and the
# dense tensor-core bf16 and float32 (outside the tensor cores; TF32 is off)
# peaks
HBM_BYTES_PER_S = {H100: 3.35e12}
PEAK_FLOP_PER_S = {(H100, "bfloat16"): 989e12, (H100, "float32"): 67e12}

# a stage delta shorter than this (ms) gets no rate, as in tools/roofline.py
MIN_RATE_MS = 0.05
# rounds of `_best_ms` (tools/roofline.py takes the best of 2 passes)
TIME_REPS = 5

_ZERO = {"detach", "alias", "expand", "as_strided", "_unsafe_view", "lift_fresh",
         "lift_fresh_copy", "empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "resize_", "set_", "record_stream"}
_WRITE_ONLY = {"fill_", "zero_"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take_along_dim"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl", "_index_put_impl_", "scatter",
             "scatter_", "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
             "index_add", "index_add_"}

_local = threading.local()


def nbytes(*tensors):
    """Bytes of the tensors, numel times the element size (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _distinct_bytes(t):
    """Bytes of the distinct elements of `t`: a stride-0 (broadcast)
    dimension is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _touched(dest, indices):
    """Elements of `dest` that `dest[indices]` names (index_put_'s indices:
    a list of index tensors, None for a whole dimension)."""
    free, d, shapes = 1, 0, []
    for ix in indices:
        if ix is None:
            free *= dest.shape[d]
            d += 1
        elif ix.dtype in (torch.bool, torch.uint8):
            shapes.append((int(ix.sum()),))
            d += ix.dim()
        else:
            shapes.append(tuple(ix.shape))
            d += 1
    free *= math.prod(dest.shape[d:])
    return math.prod(torch.broadcast_shapes(*shapes)) * free


class Count:
    """One counted run. `bytes`: device traffic of the ops and the declared
    kernels; `flops`; `transfer_bytes`: host <-> card copies; `host_ops`: ops
    left out because their result lives elsewhere than the counted device;
    `by_op` / `flops_by_op`: the same per op (`aten.mm`, ...) and declared
    kernel (`kernel:<name>`); `kernels`: the declared calls per name."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.bytes = 0
        self.flops = 0
        self.transfer_bytes = 0
        self.host_ops = 0
        self.by_op = collections.Counter()
        self.flops_by_op = collections.Counter()
        self.kernels = collections.Counter()

    def add(self, name, nbytes_, flops):
        self.bytes += int(nbytes_)
        self.flops += int(flops)
        self.by_op[name] += int(nbytes_)
        self.flops_by_op[name] += int(flops)

    def on_device(self, dev):
        return dev.type == self.device.type and (self.device.index is None
                                                 or dev.index == self.device.index)


def op_cost(func, args, kwargs, out):
    """(bytes, flops) of one aten op by the counting rules of the module
    docstring; None for a copy between devices."""
    from torch.utils.flop_counter import flop_registry

    name = func.overloadpacket.__name__
    ins = _tensors((args, {k: v for k, v in kwargs.items() if k != "out"}))
    outs = _tensors(out)
    flop_fn = flop_registry.get(func.overloadpacket)
    flops = flop_fn(*args, **kwargs, out_val=out) if flop_fn is not None else 0
    if func.is_view or name in _ZERO:
        return 0, flops
    if name in ("_to_copy", "copy_") and len({t.device for t in ins + outs}) > 1:
        return None
    if name == "_local_scalar_dense":  # .item(): a read to the host
        return None if ins[0].device.type != "cpu" else (0, 0)
    if name == "copy_":
        return _distinct_bytes(args[1]) + _distinct_bytes(args[0]), flops
    if name in _WRITE_ONLY or name.startswith("new_") or name.endswith("_like"):
        return sum(_distinct_bytes(t) for t in outs), flops
    if name in _GATHERS:
        return sum(_distinct_bytes(t) for t in ins[1:]) + 2 * nbytes(*outs), flops
    if name in _SCATTERS:
        dest = args[0]
        if name.startswith(("index_put", "_index_put")):
            idx, src = _tensors(args[1]), args[2]
            touched = _touched(dest, args[1])
        else:  # scatter*(self, dim, index, src|value, ...), index_add(self, dim, index, source)
            idx, src = [args[2]], args[3] if len(args) > 3 else kwargs.get("src")
            touched = src.numel() if name.startswith("index_add") else args[2].numel()
        b = sum(_distinct_bytes(t) for t in idx) + 2 * touched * dest.element_size()
        if isinstance(src, torch.Tensor):
            b += _distinct_bytes(src)
        if not name.endswith("_"):
            b += 2 * nbytes(dest)
        return b, flops
    return sum(_distinct_bytes(t) for t in ins) + sum(_distinct_bytes(t) for t in outs), flops


class _CountingMode(TorchDispatchMode):
    def __init__(self, count):
        super().__init__()
        self.count = count
        self.suspended = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.suspended:
            return out
        c = self.count
        first = _tensors(out) or _tensors((args, kwargs))
        cost = op_cost(func, args, kwargs, out)
        if cost is None:  # host <-> card
            c.transfer_bytes += nbytes(*_tensors(out)) or nbytes(*_tensors(args)[:1])
        elif first and not c.on_device(first[0].device):
            c.host_ops += 1
        else:
            c.add(str(func.overloadpacket), *cost)
        return out


def _active():
    if not hasattr(_local, "modes"):
        _local.modes = []
    return _local.modes


@contextlib.contextmanager
def counting(device):
    """Count the bytes and FLOPs of the ops run inside, on `device`
    (module docstring); yields the `Count`, filled when the block ends."""
    count = Count(device)
    mode = _CountingMode(count)
    _active().append(mode)
    try:
        with mode:
            yield count
    finally:
        _active().remove(mode)


@contextlib.contextmanager
def _declared(key, nbytes_, flops, kernel=None):
    modes = list(_active())
    for m in modes:
        m.count.add(key, nbytes_, flops)
        if kernel is not None:
            m.count.kernels[kernel] += 1
        m.suspended += 1
    try:
        yield
    finally:
        for m in modes:
            m.suspended -= 1


def note_kernel(name, nbytes_, flops):
    """Context manager: declare one call of the hand-written kernel `name`,
    of `nbytes_` bytes and `flops` FLOPs, to every active count (nothing
    when none is active), and count nothing of the ops run inside: the
    wrapper's own tensors, or the plain version standing in for the
    kernel."""
    return _declared(f"kernel:{name}", nbytes_, flops, kernel=name)


def stand_in(op, nbytes_, flops):
    """Context manager: count the ops run inside as one call of the library
    op `op` (e.g. "aten.mm") the card runs in their place, of `nbytes_`
    bytes and `flops` FLOPs."""
    return _declared(op, nbytes_, flops)


def mm_cost(a, b, out_dtype):
    """(bytes, flops) of one product a (M, K) @ b (K, N) with an `out_dtype`
    result, each operand read once and the result written once."""
    M, K = a.shape
    N = b.shape[1]
    return nbytes(a, b) + M * N * out_dtype.itemsize, 2 * M * N * K


def peak_bytes_per_s(device_name):
    return HBM_BYTES_PER_S.get(device_name)


def peak_flop_per_s(device_name, dtype):
    return PEAK_FLOP_PER_S.get((device_name, dtype))


def _best_ms(programs, inputs):
    """Each program's (ms per frame, spread) on the card, tools/roofline.py's
    `time_async` with the programs timed in turn: two warm calls of each
    (frames 0 and 1), then TIME_REPS rounds, each timing one pass of every
    program over the frames between one CUDA-event pair. A program's time
    is its best pass over the frame count, its spread the median pass less
    the best. A prefix of this host-bound render varies by ms from pass to
    pass, so a stage's delta, the difference of two such times, needs the
    drift to reach both alike, the best of several passes, and a spread to
    be read against."""
    n = len(inputs)
    for fn in programs:
        fn(*inputs[0])
        fn(*inputs[1 % n])
    torch.cuda.synchronize()
    times = [[] for _ in programs]
    for _ in range(TIME_REPS):
        for i, fn in enumerate(programs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for inp in inputs:
                fn(*inp)
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / n)
    return [(min(t), statistics.median(t) - min(t)) for t in times]


def _rates(nbytes_, flops, ms, peak, noise_ms=0.0):
    """(GB/s, % of the HBM peak, TFLOP/s) over `ms`; all None for no time,
    one at or under MIN_RATE_MS or within `noise_ms`, and the share None
    without a peak."""
    if ms is None or ms <= max(MIN_RATE_MS, noise_ms):
        return None, None, None
    s = ms / 1e3
    return (round(nbytes_ / s / 1e9, 3),
            None if peak is None else round(nbytes_ / s / peak * 100.0, 4),
            round(flops / s / 1e12, 4))


def ladder(render, frames, feats):
    """tools/roofline.py's ladder on the port. `frames`: device batches
    (render/base.batch_to_device), `feats`: the encoder's feature maps of
    each (`render.encode_fn()`).

    The programs: every prefix of render/demo.py STOP_STAGES in order, then
    None (the whole render), with `render.pallas_point` forced off (restored
    after), then the configured program (the fused point-stage kernel where
    `pallas_point` is on). Each is counted once on frame 0, untimed, then
    timed over the frames (`_best_ms`); on the CPU a program's time is its
    counted pass on the host clock, which says nothing of the card.

    Each ladder row holds roofline.py's keys: `stage`, `total_ms`,
    `delta_ms`, `delta_GB`, `delta_GFLOP`, `achieved_GBps`, `pct_bw_roof`,
    `achieved_TFLOPs`, and `noise_ms`, the spreads of the two totals
    summed. The rates are None where `delta_ms` <= MIN_RATE_MS, as in
    roofline.py, and where it is within `noise_ms`: a delta that the
    timing's own spread can make is no measured rate (a stage of 0.7 GB
    timed at 0.2 ms would read above the roof). They are None on the CPU,
    and the share for a card `HBM_BYTES_PER_S` lacks. The
    production row: `total_ms`, `total_GB`, `total_GFLOP`, `achieved_GBps`,
    `pct_bw_roof`, and what eager PyTorch adds to XLA's keys: the declared
    kernels' calls (`kernels`) and bytes (`kernel_GB`), the copies between
    host and card kept apart (`transfer_GB`), and a `note`. Returns
    {"ladder": rows, "production": row}."""
    from gpnerf_tpu_torch.render.demo import STOP_STAGES

    dev = feats[0].device
    cuda = dev.type == "cuda"
    peak = peak_bytes_per_s(torch.cuda.get_device_name(dev)) if cuda else None
    inputs = list(zip(frames, feats))
    orig = render.pallas_point
    stages = [(st, False) for st in (*STOP_STAGES, None)] + [(None, orig)]

    def program(stage, pallas_point):
        def run(b, f):
            render.pallas_point = pallas_point
            return render._demo_impl(b, f, stop_stage=stage)
        return run

    programs = [program(*st) for st in stages]
    counts, host_ms = [], []
    try:
        with torch.no_grad():
            for fn in programs:
                t0 = time.perf_counter()
                with counting(dev) as c:
                    fn(*inputs[0])
                host_ms.append((time.perf_counter() - t0) * 1e3)
                counts.append(c)
            timed = _best_ms(programs, inputs) if cuda else [(t, None) for t in host_ms]
    finally:
        render.pallas_point = orig

    rows = []
    prev_ms = prev_b = prev_f = prev_spread = 0
    for (stage, _), c, (t, spread) in zip(stages[:-1], counts, timed):
        dt, db, df = t - prev_ms, c.bytes - prev_b, c.flops - prev_f
        noise = None if spread is None else spread + prev_spread
        gbps, pct, tflops = _rates(db, df, dt if cuda else None, peak, noise or 0.0)
        rows.append({
            "stage": str(stage), "total_ms": round(t, 3), "delta_ms": round(dt, 3),
            "delta_GB": round(db / 1e9, 6), "delta_GFLOP": round(df / 1e9, 4),
            "achieved_GBps": gbps, "pct_bw_roof": pct, "achieved_TFLOPs": tflops,
            "noise_ms": None if noise is None else round(noise, 3),
        })
        prev_ms, prev_b, prev_f, prev_spread = t, c.bytes, c.flops, spread
    c, (t, _) = counts[-1], timed[-1]
    gbps, pct, _ = _rates(c.bytes, c.flops, t if cuda else None, peak)
    prod = {
        "stage": "production(fused)" if orig else "production(op-by-op)",
        "total_ms": round(t, 3), "total_GB": round(c.bytes / 1e9, 6),
        "total_GFLOP": round(c.flops / 1e9, 4), "achieved_GBps": gbps, "pct_bw_roof": pct,
        "kernels": dict(c.kernels),
        "kernel_GB": round(sum(v for k, v in c.by_op.items() if k.startswith("kernel:")) / 1e9, 6),
        "transfer_GB": round(c.transfer_bytes / 1e9, 6),
        "note": "each hand-written kernel counted by its declared operand and result bytes "
                "(ops modules' cost), each eager op by its operands and results",
    }
    return {"ladder": rows, "production": prod}
