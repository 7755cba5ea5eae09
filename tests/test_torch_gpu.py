"""Tests of the port that need a CUDA device. They carry the `gpu` marker
and skip without a card; on the GPU machine run them with

    python -m pytest tests/test_torch_gpu.py -m gpu -q

They import only torch and the port (the GPU machine has no flax): the
point-stage, quad-lerp and row-gather CUDA kernels against their plain
versions at ragged sizes (for the point stages, sizes that end inside a
16-row tile and inside a warp), the
wrappers' refusal of other forms, 128^2 renders on the card against the
same render on the CPU, and one train step on the card against the CPU."""

import os
import random

import numpy as np
import pytest
import torch

from gpnerf_tpu_torch.models.heads import NeRFHead
from gpnerf_tpu_torch.ops import point_stages as ps

CKPT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "bench_ckpt.pth")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(P, seed, dev):
    rs = np.random.RandomState(seed)
    V, C, C0, C1 = ps.V, ps.C, ps.C0, ps.C1
    gw0 = rs.rand(8, P).astype(np.float32)
    arrays = (
        rs.randint(-127, 128, size=(V * P, 4 * C)).astype(np.int8),
        (rs.rand(V, 4, P) * (rs.rand(V, 4, P) > 0.1)).astype(np.float32),
        (0.02 + rs.rand(C) * 0.05).astype(np.float32),
        (
            (rs.randint(0, 256, size=(P, 8 * C0)).astype(np.uint8),
             gw0 / gw0.sum(0), (0.01 + rs.rand(C0) * 0.03).astype(np.float32)),
            (rs.randint(-127, 128, size=(P, C1)).astype(np.int8),
             (rs.rand(1, P) > 0.05).astype(np.float32),
             (0.01 + rs.rand(C1) * 0.03).astype(np.float32)),
        ),
        (rs.rand(V, P) > 0.15).astype(np.float32),
        rs.rand(P) > 0.2,
    )

    def to(x):
        if isinstance(x, tuple):
            return tuple(to(y) for y in x)
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    torch.manual_seed(seed)
    head = NeRFHead(in_feat_ch=C - 3, n_smpl=8, code_dim=8).to(dev)
    return to(arrays) + (ps.pack_head_weights(head, fold_nch=C0),)


# sizes that end inside a 16-row tensor-core tile and inside a warp
RAGGED = (16, 17, 31, 33, 127, 129)


def _assert_near(d, P):
    """Kernel vs plain, |d| per value (rows = points): all within 0.08 and
    nearly all within 1e-4. bf16 dot inputs are summed in another order, so
    a float32 ulp can move one input across a bf16 rounding edge for a few
    points (tests/test_torch_point_stages.py): at most 0.5% of the values
    beyond 1e-4; at the ragged sizes, where one point's values are already
    more than 0.5%, at most one point."""
    assert d.max() < 0.08
    beyond = d > 1e-4
    if P in RAGGED:
        assert beyond.reshape(len(d), -1).any(-1).sum() <= 1
    else:
        assert beyond.mean() <= 0.005


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, *RAGGED, 255, 256, 1000, 70001])
def test_kernel_matches_plain(P):
    dev = _cuda()
    args = _inputs(P, P, dev)
    before = ps.LAUNCHES["a"]
    a, rgb = ps.fused_point_stages(*args)
    torch.cuda.synchronize()
    assert ps.LAUNCHES["a"] == before + 1
    a_p, rgb_p = ps.point_stages_plain(*args)
    a, rgb, a_p, rgb_p = (t.cpu().numpy() for t in (a, rgb, a_p, rgb_p))
    assert np.isfinite(a).all() and np.isfinite(rgb).all()
    # all points within the bounds of tests/test_pallas_point.py
    _assert_near(np.abs(a - a_p), P)
    agree = (a > 1e-14) == (a_p > 1e-14)
    assert (~agree).sum() <= max(1, 0.001 * P)
    _assert_near(np.abs(rgb - rgb_p)[agree], P)


@pytest.mark.gpu
def test_kernel_refuses_other_forms():
    dev = _cuda()
    rows, w4, pscale, geom, vmask, sig_ok, weights = _inputs(300, 0, dev)
    with pytest.raises(NotImplementedError, match="rows"):
        ps.fused_point_stages(rows.to(torch.int16), w4, pscale, geom, vmask, sig_ok, weights)
    with pytest.raises(NotImplementedError, match="geometry"):
        ps.fused_point_stages(rows, w4, pscale, geom[:1], vmask, sig_ok, weights)


def _form_inputs(form, P, seed, dev):
    """Seeded inputs of one instantiation (a key of ps.FORMS) at the widths
    the kernel is written for."""
    proj, use_feats, occ = form
    rs = np.random.RandomState(seed)
    V, C, CS, CF, C0, C1 = ps.V, ps.C, ps.CS, ps.CF, ps.C0, ps.C1

    def w4():
        return (rs.rand(V, 4, P) * (rs.rand(V, 4, P) > 0.1)).astype(np.float32)

    if proj == "merged_i8":
        tabs = ((rs.randint(-127, 128, size=(V * P, 4 * C)).astype(np.int8), w4(),
                 (0.02 + rs.rand(C) * 0.05).astype(np.float32)),)
    else:
        feat = (rs.randint(0, 256, size=(V * P, 2 * CF)).astype(np.uint8) if proj == "split_i4"
                else rs.randint(-127, 128, size=(V * P, 4 * CF)).astype(np.int8))
        tabs = ((rs.randint(0, 256, size=(V * P, 4 * CS)).astype(np.uint8), w4(),
                 np.full((CS,), 1 / 255.0, np.float32)),
                (feat, w4(), (0.02 + rs.rand(CF) * 0.05).astype(np.float32)))
    feats, kw = None, {}
    if use_feats:
        feats = (rs.randn(P, C0 + C1) * 0.5).astype(np.float32)
    else:
        gw0 = rs.rand(8, P).astype(np.float32)
        g0 = rs.randint(0, 256, size=(P, 8 * C0)).astype(np.uint8)
        if occ:
            g0[rs.rand(P) > 0.6] = 0  # empty cells, so the cull bites
        kw["geom_tabs"] = (
            (g0, gw0 / gw0.sum(0), (0.01 + rs.rand(C0) * 0.03).astype(np.float32)),
            (rs.randint(-127, 128, size=(P, C1)).astype(np.int8),
             (rs.rand(1, P) > 0.05).astype(np.float32),
             (0.01 + rs.rand(C1) * 0.03).astype(np.float32)),
        )
    vmask = (rs.rand(V, P) > 0.15).astype(np.float32)
    sig_ok = rs.rand(P) > 0.2

    def to(x):
        if isinstance(x, tuple):
            return tuple(to(y) for y in x)
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    torch.manual_seed(seed)
    head = NeRFHead(in_feat_ch=C - 3, n_smpl=8, code_dim=8).to(dev)
    kw = {k: to(v) for k, v in kw.items()}
    if occ:
        kw["occ_geom"] = True
    return (to(tabs), to(feats), to(vmask), to(sig_ok), ps.pack_head_weights(head, fold_nch=C0)), kw


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, *RAGGED, 257, 70001])
@pytest.mark.parametrize("name", ["a+b", "c", "c+e", "c+d", "b+c"])
def test_form_kernel_matches_plain(name, P):
    dev = _cuda()
    form = {v: k for k, v in ps.FORMS.items()}[name]
    args, kw = _form_inputs(form, P, P, dev)
    before = ps.LAUNCHES[name]
    out = ps.fused_point_stages_tabs(*args, **kw)
    torch.cuda.synchronize()
    assert ps.LAUNCHES[name] == before + 1
    out_p = ps.point_stages_tabs_plain(*args, **kw)
    assert len(out) == len(out_p) == (3 if form[2] else 2)
    a, rgb, a_p, rgb_p = (t.cpu().numpy() for t in (*out[:2], *out_p[:2]))
    assert np.isfinite(a).all() and np.isfinite(rgb).all()
    # the tolerances of test_kernel_matches_plain
    _assert_near(np.abs(a - a_p), P)
    agree = (a > 1e-14) == (a_p > 1e-14)
    assert (~agree).sum() <= max(1, 0.001 * P)
    _assert_near(np.abs(rgb - rgb_p)[agree], P)
    if form[2]:
        # a sum of non-negative terms compared with 0: exact
        np.testing.assert_array_equal(out[2].cpu().numpy(), out_p[2].cpu().numpy())
        if P > 1000:
            assert 0.3 < float(out[2].mean()) < 0.9


@pytest.mark.gpu
def test_kernel_refuses_forms_without_instantiation():
    dev = _cuda()
    before = sum(ps.LAUNCHES.values())
    args, kw = _form_inputs(("split_i4", False, True), 300, 0, dev)
    with pytest.raises(NotImplementedError, match="no instantiation"):
        ps.fused_point_stages_tabs(*args, **kw)
    args, kw = _form_inputs(("split_i4", True, False), 300, 0, dev)
    with pytest.raises(NotImplementedError, match="no instantiation"):
        ps.fused_point_stages_tabs(*args, **kw)
    (tabs, feats, vmask, sig_ok, weights), kw = _form_inputs(("split_i8", True, False), 300, 0, dev)
    with pytest.raises(NotImplementedError, match="geometry features"):
        ps.fused_point_stages_tabs(tabs, feats[:, :64].contiguous(), vmask, sig_ok, weights)
    with pytest.raises(NotImplementedError, match="tap weights"):
        ps.fused_point_stages_tabs(
            ((tabs[0][0], tabs[0][1][:2].contiguous(), tabs[0][2]), tabs[1]), feats, vmask, sig_ok, weights)
    assert sum(ps.LAUNCHES.values()) == before


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fast", "reference", "frame_mode", "neg fast",
                                  "neg reference"])
def test_render_on_card_matches_cpu(mode):
    """128^2 renders on the card against the CPU; "neg" modes render the
    `thuman-synthetic` frame (THuman's neg-ray convention), whose ray masks
    and ray and sample counts must be identical on both devices."""
    dev = _cuda()
    neg = mode.startswith("neg ")
    mode = mode.split()[-1]
    from gpnerf_tpu_torch.config import cfg as base
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = cfg.dataset.W = 128
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.tpu.matmul_dtype = "float32"
    cfg.tpu.ray_cap = 16384
    if mode != "fast":
        cfg.tpu.tight_cull = False
        cfg.tpu.samples_per_ray = 64
        cfg.tpu.tap_window = 0
        cfg.tpu.merge_lowres_src = False
        cfg.tpu.ray_cap = 9216
        cfg.tpu.frame_mode = mode == "frame_mode"
    if neg:
        cfg.dataset.test.name = "thuman-synthetic"
    cfg.freeze()
    np.random.seed(0)
    random.seed(0)
    batch = get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    outs = {}
    for d in (dev, torch.device("cpu")):
        r = load_eval_model(CKPT, get("render", "demo_render")(cfg, device=d))
        assert r.neg_ray_val == neg
        outs[d.type] = {k: v.cpu() for k, v in r.render_demo_fn()(batch_to_device(batch, d)).items()}
    g, c = outs["cuda"], outs["cpu"]
    assert (g["mask_at_box"] == c["mask_at_box"]).float().mean() > 0.999
    if neg:
        assert torch.equal(g["mask_at_box"], c["mask_at_box"])
        assert torch.equal(g["counts"][:2], c["counts"][:2])
        assert torch.equal(g["overflows"], c["overflows"])
    np.testing.assert_array_equal(g["overflows"].numpy()[[0, 2, 3]], 0)
    assert abs(int(g["counts"][2]) - int(c["counts"][2])) <= 0.001 * int(c["counts"][2])
    m = g["mask_at_box"] & c["mask_at_box"]
    d = (g["pred_chw"].reshape(3, -1)[:, m] - c["pred_chw"].reshape(3, -1)[:, m]).abs()
    assert float(d.median()) < 2e-3 and float((d > 0.05).float().mean()) <= 1e-3
    # fast mode as before; the blanket's rays of image row 0 project onto a
    # source image's border row to the last bit, where a view flips in or out
    assert float(d.max()) < (0.05 if mode == "fast" else 0.15)


# --- the quad-lerp kernels and the row gather (ops/quad_lerp.py, row_gather.py)


def _lerp_inputs(row_dtype, V, P, C, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    if row_dtype == torch.float32:
        rows = torch.randn(V * P, 4 * C, generator=g, device=dev)
    else:
        lo, hi = (0, 256) if row_dtype == torch.uint8 else (-127, 128)
        rows = torch.randint(lo, hi, (V * P, 4 * C), generator=g, device=dev, dtype=row_dtype)
    w4 = torch.rand(V, 4, P, generator=g, device=dev)
    w4 = w4 * (torch.rand(V, 4, P, generator=g, device=dev) > 0.1)
    scale = 0.02 + 0.05 * torch.rand(C, generator=g, device=dev)
    return rows, w4, scale


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row_dtype", [torch.int8, torch.uint8, torch.float32])
@pytest.mark.parametrize("P,C", [(1, 35), (127, 35), (129, 6), (70001, 35), (1000, 96)])
def test_quad_lerp_kernels_match_plain_bitwise(P, C, row_dtype, out_dtype):
    from gpnerf_tpu_torch.ops import quad_lerp as ql

    dev = _cuda()
    V = 3
    rows, w4, scale = _lerp_inputs(row_dtype, V, P, C, P + C, dev)
    before = dict(ql.LAUNCHES)
    out = ql.quad_lerp_rows_vcp(rows, w4, scale, out_dtype=out_dtype)
    w_flat = w4.permute(1, 0, 2).reshape(4, V * P).contiguous()
    out_cm = ql.quad_lerp_rows_cm(rows, w_flat, scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    # a CUDA tensor goes through the kernel, once per call
    assert ql.LAUNCHES["quad_lerp_rows_vcp"] == before.get("quad_lerp_rows_vcp", 0) + 1
    assert ql.LAUNCHES["quad_lerp_rows_cm"] == before.get("quad_lerp_rows_cm", 0) + 1
    ref = ql.quad_lerp_rows_vcp_plain(rows, w4, scale, out_dtype=out_dtype)
    assert out.dtype == out_dtype and tuple(out.shape) == (V, C, P)
    # the same rounded float32 products and sums in the same order: bitwise
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(_bits(out_cm), _bits(ref.permute(1, 0, 2).reshape(C, V * P)))
    assert torch.equal(_bits(out_cm),
                       _bits(ql.quad_lerp_rows_cm_plain(rows, w_flat, scale, out_dtype=out_dtype)))


@pytest.mark.gpu
def test_quad_lerp_refuses_what_it_does_not_take():
    from gpnerf_tpu_torch.ops import quad_lerp as ql

    dev = _cuda()
    rows, w4, scale = _lerp_inputs(torch.int8, 3, 300, 35, 0, dev)
    before = sum(ql.LAUNCHES.values())
    with pytest.raises(NotImplementedError, match="no kernel"):
        ql.quad_lerp_rows_vcp(rows.to(torch.int16), w4, scale)
    with pytest.raises(NotImplementedError, match="no kernel"):
        ql.quad_lerp_rows_vcp(rows, w4, scale, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="fit together"):
        ql.quad_lerp_rows_vcp(rows, w4, scale[:34].contiguous())
    with pytest.raises(ValueError, match="rows for V"):
        ql.quad_lerp_rows_vcp(rows[:-1], w4, scale)
    with pytest.raises(ValueError, match="contiguous"):
        ql.quad_lerp_rows_cm(rows, w4.permute(1, 0, 2).reshape(4, -1).T.contiguous().T, scale)
    big = torch.zeros(4, 4 * 97, dtype=torch.int8, device=dev)
    with pytest.raises(NotImplementedError, match="shared-memory"):
        ql.quad_lerp_rows_cm(big, torch.zeros(4, 4, device=dev), torch.ones(97, device=dev))
    assert sum(ql.LAUNCHES.values()) == before


@pytest.mark.gpu
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype,C", [(torch.float32, 32), (torch.bfloat16, 32),
                                     (torch.float32, 3), (torch.bfloat16, 6)])
@pytest.mark.parametrize("N", [1, 1000, 70001])
def test_row_gather_kernel_matches_plain_bitwise(N, dtype, C, idx_dtype):
    from gpnerf_tpu_torch.ops import row_gather as rg

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(N)
    table = torch.randn(20480, C, generator=g, device=dev).to(dtype)
    idx = torch.randint(0, 20480, (N,), generator=g, device=dev, dtype=idx_dtype)
    before = rg.LAUNCHES["row_gather"]
    out = rg.row_gather(table, idx)
    torch.cuda.synchronize()
    assert rg.LAUNCHES["row_gather"] == before + 1
    assert out.dtype == dtype and torch.equal(_bits(out), _bits(rg.row_gather_plain(table, idx)))


@pytest.mark.gpu
def test_row_gather_refuses_what_it_does_not_take():
    from gpnerf_tpu_torch.ops import row_gather as rg

    dev = _cuda()
    table = torch.zeros(16, 3, dtype=torch.bfloat16, device=dev)  # 6-byte rows
    idx = torch.zeros(4, dtype=torch.int32, device=dev)
    before = rg.LAUNCHES["row_gather"]
    with pytest.raises(NotImplementedError, match="4-byte words"):
        rg.row_gather(table, idx)
    with pytest.raises(NotImplementedError, match="int32 or int64"):
        rg.row_gather(table.float(), idx.to(torch.int16))
    with pytest.raises(ValueError, match="contiguous"):
        rg.row_gather(torch.zeros(16, 8, device=dev)[:, ::2], idx)
    assert rg.LAUNCHES["row_gather"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fast", "reference"])
def test_opbyop_render_on_card_matches_cpu(mode):
    """The op-by-op point stages (pallas_point off): the card runs the
    quad-lerp kernel where the CPU runs its plain version."""
    dev = _cuda()
    from gpnerf_tpu_torch.config import cfg as base
    from gpnerf_tpu_torch.ops import quad_lerp as ql
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = cfg.dataset.W = 128
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.tpu.matmul_dtype = "float32"
    cfg.tpu.ray_cap = 16384
    cfg.tpu.pallas_point = False
    if mode != "fast":
        cfg.tpu.tight_cull = False
        cfg.tpu.samples_per_ray = 64
        cfg.tpu.tap_window = 0
        cfg.tpu.merge_lowres_src = False
        cfg.tpu.ray_cap = 9216
    cfg.freeze()
    np.random.seed(0)
    random.seed(0)
    batch = get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    outs = {}
    lerps, points = ql.LAUNCHES["quad_lerp_rows_vcp"], sum(ps.LAUNCHES.values())
    for d in (dev, torch.device("cpu")):
        r = load_eval_model(CKPT, get("render", "demo_render")(cfg, device=d))
        outs[d.type] = {k: v.cpu() for k, v in r.render_demo_fn()(batch_to_device(batch, d)).items()}
    # the merged table's lerp went through its kernel once, on the card
    # only; the split tables have no kernel route; no point-stage launch
    assert ql.LAUNCHES["quad_lerp_rows_vcp"] == lerps + (mode == "fast")
    assert sum(ps.LAUNCHES.values()) == points
    g, c = outs["cuda"], outs["cpu"]
    assert (g["mask_at_box"] == c["mask_at_box"]).float().mean() > 0.999
    np.testing.assert_array_equal(g["overflows"].numpy()[[0, 2, 3]], 0)
    assert abs(int(g["counts"][2]) - int(c["counts"][2])) <= 0.001 * int(c["counts"][2])
    m = g["mask_at_box"] & c["mask_at_box"]
    d = (g["pred_chw"].reshape(3, -1)[:, m] - c["pred_chw"].reshape(3, -1)[:, m]).abs()
    # float32 heads on both devices, sums in another order
    assert float(d.median()) < 1e-4 and float((d > 0.05).float().mean()) <= 1e-3
    assert float(d.max()) < (0.05 if mode == "fast" else 0.15)


# --- the training path (render/base.py, train/step.py)


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu():
    """One AdamW step of the training renderer at 128^2 from the trained
    checkpoint (ResNet34-UNet, code_dim 32, 256 rays x 16 samples), the
    same batch and jitter draws on the card and on the CPU. The card's
    convolutions and index_add backward (atomics) sum in other orders, and
    the loss is only piecewise smooth (ReLU kinks under the BatchNorms'
    cancelling backward; tests/test_torch_train_step.py), so: loss within
    1e-5 relative, rgb_map within 1e-4; each gradient within 1e-2 relative
    L2, the norm layers' scales and biases (column sums whose terms cancel)
    within 3e-2, the median within 1e-3 (measured on the H100: 6.2e-3,
    1.15e-2 and 5.5e-6); the exactly-zero gradients at noise level on both;
    running statistics within 1e-5; parameters after the step within 1e-6
    but for at most 0.5% of the elements (direction flips of near-zero
    gradients, within 2 lr)."""
    dev = _cuda()
    from gpnerf_tpu_torch.config import cfg as base
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.train.criterion import Criterion
    from gpnerf_tpu_torch.train.step import make_optimizer, train_step

    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = cfg.dataset.W = 128
    cfg.head.sigma.code_dim = 32
    cfg.train.n_rays = 256
    cfg.train.n_samples = 16
    cfg.freeze()
    np.random.seed(0)
    random.seed(0)
    batch = get("dataset", cfg.dataset.train.file)(cfg, is_train=True)[0]
    t_rand = torch.rand(256, 16, generator=torch.Generator().manual_seed(3))
    out = {}
    for d in (dev, torch.device("cpu")):
        r = load_eval_model(CKPT, get("render", "BaseRender")(cfg, device=d))
        opt, sched, _ = make_optimizer(r, cfg)
        before = {k: p.detach().clone() for k, p in r.named_parameters()}
        metrics, ret = train_step(r, Criterion(cfg), opt, sched, batch_to_device(batch, d),
                                  t_rand=t_rand.to(d))
        out[d.type] = {
            "loss": float(metrics["loss"]), "overflow": int(metrics["overflow"]),
            "rgb": ret["rgb_map"].detach().cpu(),
            "grads": {k: p.grad.cpu() for k, p in r.named_parameters()},
            "params": {k: p.detach().cpu() for k, p in r.named_parameters()},
            "before": {k: v.cpu() for k, v in before.items()},
            "stats": {k: v.cpu() for k, v in r.state_dict().items() if "running" in k},
        }
    g, c = out["cuda"], out["cpu"]
    assert abs(g["loss"] - c["loss"]) <= 1e-5 * c["loss"] and g["overflow"] == c["overflow"] == 0
    assert float((g["rgb"] - c["rgb"]).abs().max()) <= 1e-4
    total = float(sum(float((v.double() ** 2).sum()) for v in c["grads"].values())) ** 0.5
    errs = {}
    for k, gc in c["grads"].items():
        n = float(gc.norm())
        if n <= 1e-6 * total:  # an exactly-zero gradient: rounding noise on both
            assert float(g["grads"][k].norm()) <= 1e-6 * total, k
            continue
        errs[k] = float((g["grads"][k] - gc).norm()) / n
    norms = {k for k, m in r.named_modules() if type(m).__name__ in ("InstanceNorm", "MaskedBatchNorm")}
    for k, e in errs.items():
        assert e <= (3e-2 if k.rsplit(".", 1)[0] in norms else 1e-2), (k, e)
    assert np.median(list(errs.values())) <= 1e-3
    for k, v in c["stats"].items():
        assert float((g["stats"][k] - v).abs().max()) <= 1e-5, k
    lr, n_over, n_all = cfg.train.lr, 0, 0
    for k, pc in c["params"].items():
        diff = (g["params"][k] - pc).abs()
        assert float(diff.max()) <= 2 * lr, k
        n_over += int((diff > 1e-6).sum())
        n_all += pc.numel()
    assert n_over <= 5e-3 * n_all, (n_over, n_all)
