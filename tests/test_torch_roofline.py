"""The port's roofline (gpnerf_tpu_torch/utils/roofline.py, the counterpart
of XLA's cost_analysis() in tools/roofline.py and bench.py) on the CPU:

  * the counting rules: a matmul of known shapes counts 2*M*N*K FLOPs and
    its operands and result once; a view or `expand` costs 0; `table[idx]`
    and `index_select` count the indices and twice the output whatever the
    table's size; `index_put_` and `scatter_add_` count the touched rows;
    ops off the counted device are host ops and cost nothing;
  * the kernels' declared costs: each plain version under `counting` adds
    exactly its declared cost and none of its own ops (the point-stage
    entry on the seeded tables of tests/point_tables.py, both quad lerps,
    the row gather), and those costs equal the formulas `chip_smoke.py`
    held before they moved into the ops modules (kept here as the oracle;
    the point stages' bytes are those of the rows the kernel fetches); the
    CPU's widened stand-in for the card's bf16 product counts as that
    product;
  * FLOPs against JAX: the port's encoder at 128^2, float32, with the
    checkpoint's weights counts within 2% of XLA's cost_analysis() of the
    JAX encoder on the CPU (measured 0.9%: XLA also counts elementwise
    FLOPs, the port's count only matmuls and convolutions);
  * the ladder: tools/roofline_torch.py at 128^2 on one bench frame gives a
    row per STOP_STAGES prefix and the whole render, then production, every
    delta_GB >= 0, the rates None on the CPU, and writes its JSON; a
    stage's rates only where its delta exceeds 0.05 ms and its timings'
    spread.

The copy from the host to the card (`transfer_bytes`) and the same frame
counted on the card and on the CPU are tests/test_torch_gpu.py's.

~45 s alone, most of it the ladder's 16 renders and JAX's compile."""

import json
import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.render.base import src_norm as jax_src_norm
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.ops import point_stages as ps
from gpnerf_tpu_torch.ops import quad_lerp as ql
from gpnerf_tpu_torch.ops import row_gather as rg
from gpnerf_tpu_torch.ops.sparse_conv import _conv_gather_mm
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import src_norm
from gpnerf_tpu_torch.render.demo import STOP_STAGES
from gpnerf_tpu_torch.train.checkpoint import load_eval_model
from gpnerf_tpu_torch.utils import roofline
from gpnerf_tpu_torch.utils.roofline import counting

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
import chip_smoke  # noqa: E402  (torch and the port only; the card only inside main)
import roofline_torch  # noqa: E402
from point_tables import seeded_tables  # noqa: E402

CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Whole-frame renders under parallel test files (tests/test_torch_opbyop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _count(fn, device="cpu"):
    with torch.no_grad(), counting(device) as c:
        fn()
    return c


# --- the counting rules


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_counts_flops_and_operands(dtype):
    M, K, N = 37, 53, 29
    a, b = torch.randn(M, K, dtype=dtype), torch.randn(K, N, dtype=dtype)
    c = _count(lambda: a @ b)
    assert c.flops == 2 * M * N * K
    assert c.bytes == (M * K + K * N + M * N) * a.element_size()
    assert dict(c.by_op) == {"aten.mm": c.bytes}


def test_views_and_expand_cost_nothing():
    x = torch.randn(64, 32)
    c = _count(lambda: (x.view(32, 64), x.T, x[:, 3:9], x[None].expand(4, 64, 32), x.reshape(-1),
                        x.detach(), torch.empty(1000)))
    assert c.bytes == 0 and c.flops == 0
    # a broadcast operand is read once: one row of 32 for the 64 rows
    row = torch.randn(32)
    c = _count(lambda: x + row.expand(64, 32))
    assert c.bytes == (64 * 32 + 32 + 64 * 32) * 4


@pytest.mark.parametrize("rows", [100, 100_000])
@pytest.mark.parametrize("how", ["index", "index_select"])
def test_gather_counts_rows_read_not_the_table(how, rows):
    table = torch.randn(rows, 16)
    idx = torch.randint(0, rows, (500,))
    fn = (lambda: table[idx]) if how == "index" else (lambda: table.index_select(0, idx))
    c = _count(fn)
    assert c.bytes == 500 * 8 + 2 * 500 * 16 * 4


def test_scatters_count_touched_rows():
    dest = torch.zeros(10_000, 8)
    idx = torch.randint(0, 10_000, (300,))
    src = torch.randn(300, 8)

    def put():
        dest[idx] = src

    c = _count(put)
    assert c.bytes == 300 * 8 + 300 * 8 * 4 + 2 * 300 * 8 * 4
    # a boolean mask touches its true entries; the scalar source is one value
    mask = torch.zeros(10_000, dtype=torch.bool)
    mask[:77] = True

    def put_mask():
        dest[mask] = 1.0

    c = _count(put_mask)
    assert c.by_op["aten.index_put_"] == 10_000 + 4 + 2 * 77 * 8 * 4
    # scatter_add_: one touched element per index entry
    flat = torch.zeros(10_000)
    sidx, sval = torch.randint(0, 10_000, (400,)), torch.randn(400)
    c = _count(lambda: flat.scatter_add_(0, sidx, sval))
    assert c.bytes == 400 * 8 + 400 * 4 + 2 * 400 * 4
    # out of place: the whole destination read and written as well
    c = _count(lambda: flat.scatter_add(0, sidx, sval))
    assert c.bytes == 400 * 8 + 400 * 4 + 2 * 400 * 4 + 2 * 10_000 * 4


def test_ops_off_the_counted_device_are_host_ops():
    x = torch.randn(128, 128)
    c = _count(lambda: (x @ x).sum(), device="cuda")
    assert c.bytes == 0 and c.flops == 0 and c.host_ops == 2


# --- the kernels' declared costs, against chip_smoke.py's former formulas


def _fetched_bytes(args, kw, outs):
    """The point-stage entry's bytes: each point's quad row in every view
    of every projection table and its geometry rows (or feature row) read
    once, the points, the cameras, the scales, sig_ok (as uint8) and the
    packed weights read once, the outputs written once."""
    quads, pts, KE, _, _, weights = args
    P, V = pts.shape[0], KE.shape[0]
    per_point = sum(V * q.shape[-1] * q.element_size() for q, _ in quads) + 1
    once = [pts, KE, weights.flat, *(sc for _, sc in quads), *outs]
    if kw.get("feats") is not None:
        once.append(kw["feats"])
    else:
        once.append(kw["dhw_c"])
        for table, sc in kw["geom"]:
            rows = table if isinstance(table, torch.Tensor) else table.rows
            per_point += rows.shape[-1] * rows.element_size()
            once += [] if sc is None else [sc]
    return P * per_point + sum(t.numel() * t.element_size() for t in once)


def _old_point_stage_ops(call):
    """Its (tensor-core, float32) operation counts."""
    tabs, feats, vmask, sig_ok, weights, kw = call
    V, P = vmask.shape
    Cp = sum(t[2].shape[0] for t in tabs)
    macs = sum(w.shape[0] * w.shape[1] for w, _ in weights.layers)
    macs += (V - 1) * sum(w.shape[0] * w.shape[1] for w, _ in weights.layers[5:9])
    lerp = sum(V * t[2].shape[0] * 2 * t[1].shape[1] for t in tabs) + 4 * V * Cp
    lerp += sum(g[0].shape[1] * 2 + g[2].shape[0] for g in kw.get("geom_tabs", ()))
    return P * 2 * macs, P * lerp


def _old_lerp_cost(rows, w4, scale, out):
    """chip_smoke.py's lerp_cost before: (bytes, 9 operations per output)."""
    return sum(t.numel() * t.element_size() for t in (rows, w4, scale, out)), 9 * out.numel()


@pytest.mark.parametrize("form", ["a", "a+e", "c", "a+b"])
def test_point_stages_plain_counts_its_declared_cost(form):
    key = next(k for k, n in ps.FORMS.items() if n == form)
    args, kw = seeded_tables(key, 203)
    with torch.no_grad(), counting("cpu") as c:
        outs = ps.fused_point_stages_from_tables(*args, **kw)
    nb, fl = ps.cost_from_tables(*args, **kw)
    assert dict(c.kernels) == {"point_stages": 1}
    assert dict(c.by_op) == {"kernel:point_stages": nb}
    assert c.bytes == nb == _fetched_bytes(args, kw, outs)
    # the FLOPs of the rows the kernel fetches, by the former formula
    (tabs, feats, vmask, sig_ok), g_kw = ps.gather_from_tables(*args[:5], **kw)
    assert c.flops == fl == sum(_old_point_stage_ops((tabs, feats, vmask, sig_ok, args[5], g_kw)))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row_dtype", [torch.int8, torch.bfloat16])
def test_quad_lerps_count_their_declared_cost(row_dtype, out_dtype):
    g = torch.Generator().manual_seed(0)
    V, P, C = 3, 301, 35
    rows = (torch.randint(-127, 128, (V * P, 4 * C), generator=g, dtype=torch.int8)
            if row_dtype == torch.int8 else torch.randn(V * P, 4 * C, generator=g).to(row_dtype))
    w4 = torch.rand(V, 4, P, generator=g)
    scale = torch.rand(C, generator=g)
    w4_flat = w4.permute(1, 0, 2).reshape(4, -1).contiguous()
    for name, fn, w in (("quad_lerp_rows_vcp", ql.quad_lerp_rows_vcp, w4),
                        ("quad_lerp_rows_cm", ql.quad_lerp_rows_cm, w4_flat)):
        with counting("cpu") as c:
            out = fn(rows, w, scale, out_dtype=out_dtype)
        nb, fl = ql.cost(rows, w, scale, out_dtype)
        assert dict(c.kernels) == {name: 1} and dict(c.by_op) == {f"kernel:{name}": nb}
        assert (c.bytes, c.flops) == (nb, fl) == _old_lerp_cost(rows, w, scale, out)
        assert chip_smoke.lerp_cost(rows, w, scale, out)[0] == nb


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_row_gather_counts_its_declared_cost(idx_dtype):
    table = torch.randn(2048, 32)
    idx = torch.randint(0, 2048, (10_000,), dtype=idx_dtype)
    with counting("cpu") as c:
        out = rg.row_gather(table, idx)
    nb, fl = rg.cost(table, idx)
    assert dict(c.kernels) == {"row_gather": 1} and dict(c.by_op) == {"kernel:row_gather": nb}
    # chip_smoke.py's former bound: the table, the indices and the rows once
    assert (c.bytes, c.flops) == (nb, fl) == (
        sum(t.numel() * t.element_size() for t in (table, idx, out)), 0)


@pytest.mark.parametrize("ms,noise,resolved", [
    (None, 0.0, False), (0.05, 0.0, False), (0.06, 0.0, True), (0.3, 0.5, False), (0.6, 0.5, True),
])
def test_rates_only_above_min_time_and_noise(ms, noise, resolved):
    """A stage's rates need a delta above MIN_RATE_MS (tools/roofline.py's
    0.05 ms) and above the spread of its two timings."""
    gbps, pct, tflops = roofline._rates(1e9, 2e12, ms, 3.35e12, noise)
    assert (gbps is not None) == (pct is not None) == (tflops is not None) == resolved
    if resolved:
        assert gbps == round(1.0 / (ms / 1e3), 3)
        assert pct == round(1e9 / (ms / 1e3) / 3.35e12 * 100.0, 4)


def test_wrapper_runs_without_a_count():
    table = torch.randn(64, 32)
    out = rg.row_gather(table, torch.arange(10))
    assert torch.equal(out, table[:10])


def test_widened_bf16_product_counts_as_the_cards():
    """ops/sparse_conv.py: the CPU widens the bf16 operands where the card
    runs cuBLAS's bf16 product with a float32 result; the count takes the
    card's product (`aten.mm` of bf16 operands, a float32 result)."""
    g = torch.Generator().manual_seed(0)
    N, CAP, Cin, Cout = 500, 300, 32, 32
    feats = torch.randn(N, Cin, generator=g)
    idx = torch.randint(-1, N, (CAP, 27), generator=g)
    valid = torch.rand(CAP, generator=g) > 0.2
    weight = torch.randn(27, Cin, Cout, generator=g)
    with torch.no_grad(), counting("cpu") as c:
        _conv_gather_mm(feats, idx, valid, weight, torch.bfloat16)
    assert c.flops == 2 * CAP * 27 * Cin * Cout
    assert c.by_op["aten.mm"] == (CAP * 27 * Cin + 27 * Cin * Cout) * 2 + CAP * Cout * 4
    assert not c.kernels


# --- FLOPs against XLA's cost analysis of the JAX encoder


def _cfg(base, size):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.dataset.H = cfg.dataset.W = size
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.tpu.matmul_dtype = "float32"
    cfg.freeze()
    return cfg


def test_encoder_flops_within_2pct_of_xla():
    """XLA counts every elementwise op as well (BatchNorm, ReLU, the
    normalization), so its count sits above the port's matmul and
    convolution FLOPs: 7.627 against 7.559 GFLOP at 128^2."""
    cfg = _cfg(jax_cfg, 128)
    np.random.seed(0)
    random.seed(0)
    batch = jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    jr = jax_get("render", "demo_render")(cfg)
    shapes = jax.eval_shape(lambda key: jr._init_variables_impl(key, batch), jax.random.PRNGKey(0))
    variables = jax_load(CKPT, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), 4)
    x = batch["src_imgs"]
    ca = jax.jit(jr.encoder.apply).lower(variables["encoder"], jax_src_norm(jnp.asarray(x))) \
        .compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    xla = float(ca["flops"])
    port = load_eval_model(CKPT, port_get("render", "demo_render")(_cfg(port_cfg, 128), device="cpu"))
    with torch.no_grad(), counting("cpu") as c:
        port.encoder(src_norm(torch.from_numpy(np.asarray(x))))
    print(f"encoder 128^2 float32: port {c.flops / 1e9:.4f} GFLOP, XLA {xla / 1e9:.4f}")
    assert xla > c.flops and (xla - c.flops) / xla <= 0.02


# --- the ladder


def test_ladder_tool_on_the_cpu(tmp_path):
    path = str(tmp_path / "roof.json")
    res = roofline_torch.main(
        ["--json", path, "device", "cpu", "dataset.H", "128", "dataset.W", "128", "tpu.ray_cap",
         "9216", "tpu.sigma_cap", "262144", "tpu.rgb_cap", "131072"], n_frames=1)
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    rows, prod = res["ladder"], res["production"]
    assert [r["stage"] for r in rows] == [*STOP_STAGES, "None"] and len(rows) == 15
    keys = {"stage", "total_ms", "delta_ms", "delta_GB", "delta_GFLOP", "achieved_GBps",
            "pct_bw_roof", "achieved_TFLOPs", "noise_ms"}
    for r in rows:
        assert set(r) == keys
        assert r["delta_GB"] >= 0 and r["delta_GFLOP"] >= 0, r
        assert r["achieved_GBps"] is None and r["pct_bw_roof"] is None
        assert r["achieved_TFLOPs"] is None and r["noise_ms"] is None
    assert prod["stage"] == "production(fused)" and prod["kernels"] == {"point_stages": 1}
    assert prod["total_GB"] > 0 and prod["total_GFLOP"] > 0 and prod["pct_bw_roof"] is None
    assert res["device"] == "cpu" and res["peak_GBps"] is None and res["frames"] == 1
    # the op-by-op whole render and the fused one differ only in the point stages
    assert rows[-1]["total_ms"] > 0 and 0 < prod["kernel_GB"] < prod["total_GB"]
