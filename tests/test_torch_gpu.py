"""Tests of the port that need a CUDA device. They carry the `gpu` marker
and skip without a card; on the GPU machine run them with

    python -m pytest tests/test_torch_gpu.py -m gpu -q

They import only torch and the port (the GPU machine has no flax): the
point-stage, quad-lerp and row-gather CUDA kernels against their plain
versions at ragged sizes (for the point stages, sizes that end inside a
16-row tile and inside a warp; the kernel's entry on the seeded tables of
tests/point_tables.py for FORMS' keys and keys built from a call's key,
1-8 views among them), the wrappers' refusals, 128^2 renders on the card against the
same render on the CPU, the kernel on a compacted render's points and the
compacted render against the dense-slot one, the kernel on the windowed
tap's points and the windowed renders on the card against the CPU, both
mesh paths on the card against the CPU (float32, and the demo renderer's
bf16 `matmul_dtype`), one train step on the card against the CPU (float32
and bf16 mixed precision), the native bf16 fast render on the card against
the CPU, `render_demo_scan_fn` against the per-frame loop, and the
roofline's count (utils/roofline.py) of a frame on the card against the
CPU's, with the copies between host and card kept apart."""

import os
import random

import numpy as np
import pytest
import torch

from gpnerf_tpu_torch.ops import point_stages as ps

CKPT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "bench_ckpt.pth")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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


def _assert_kernel_near_plain(out, out_p, P):
    """Kernel vs plain: all points within the bounds of
    tests/test_pallas_point.py (`_assert_near`), alive-boundary flips on at
    most 0.1% of the points, and equal occupancy verdicts (a sum of
    non-negative terms compared with 0: exact)."""
    assert len(out) == len(out_p)
    a, rgb, a_p, rgb_p = (t.cpu().numpy() for t in (*out[:2], *out_p[:2]))
    assert np.isfinite(a).all() and np.isfinite(rgb).all()
    _assert_near(np.abs(a - a_p), P)
    agree = (a > 1e-14) == (a_p > 1e-14)
    assert (~agree).sum() <= max(1, 0.001 * P)
    _assert_near(np.abs(rgb - rgb_p)[agree], P)
    if len(out) == 3:
        np.testing.assert_array_equal(out[2].cpu().numpy(), out_p[2].cpu().numpy())


def _kernel_vs_plain(key, P, dev, **kw):
    """The entry on the seeded tables of `key` at P points (seed P), one
    launch of the key's library, held against its plain version on the
    same tables on the CPU; returns the kernel's outputs. The CPU's
    projection einsum sums in the kernel's order (fused multiply-adds from
    the first product) at every P; the card's does so at the main path's
    sizes but not at every small P (at P = 127 its tap weights move by
    1.4e-6 and one point's alpha by 7.7e-4)."""
    from point_tables import seeded_tables, to_device

    key = ps.check_key(key)
    name = ps.form_name(key)
    args, t_kw = seeded_tables(key, P, seed=P, **kw)
    out_p = ps.point_stages_from_tables_plain(*args, **t_kw)
    args, t_kw = to_device(args, dev), {k: to_device(v, dev) for k, v in t_kw.items()}
    before = ps.LAUNCHES[name]
    out = ps.fused_point_stages_from_tables(*args, **t_kw)
    torch.cuda.synchronize()
    assert ps.LAUNCHES[name] == before + 1
    assert len(out) == (3 if key.occ else 2)
    _assert_kernel_near_plain(out, out_p, P)
    return out


FORM_A = ps.Key(("i8",), "default", False)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, *RAGGED, 255, 256, 1000, 70001])
def test_kernel_matches_plain(P):
    _kernel_vs_plain(FORM_A, P, _cuda())


@pytest.mark.gpu
def test_kernel_refuses_other_forms():
    from point_tables import seeded_tables

    from gpnerf_tpu_torch.ops.grid_sample import FlatOctetTable

    dev = _cuda()
    args, kw = seeded_tables(FORM_A, 300, seed=0, device=dev)
    ((t0, s0),), rest = args[0], args[1:]
    with pytest.raises(NotImplementedError, match="rows"):
        ps.fused_point_stages_from_tables(((t0.to(torch.int16), s0),), *rest, **kw)
    # one geometry table alone is a key of its own, whose sigma-feat layer
    # takes 32 inputs: the 96-input weights do not fit it
    with pytest.raises(NotImplementedError, match="packed weights"):
        ps.fused_point_stages_from_tables(*args, **{**kw, "geom": kw["geom"][:1]})
    # a table of 16 channels is no key the kernel compiles
    (g0, sc0), g1 = kw["geom"]
    assert isinstance(g0, FlatOctetTable)
    g16 = (FlatOctetTable(g0.rows[:, :8 * 16].contiguous(), g0.shape), sc0[:16].contiguous())
    with pytest.raises(NotImplementedError, match="geometry tables"):
        ps.fused_point_stages_from_tables(*args, **{**kw, "geom": (g16, g1)})


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, *RAGGED, 257, 70001])
@pytest.mark.parametrize("name", ["a+b", "c", "c+e", "c+d", "b+c", "a+e", "c+d+e", "b+c+d",
                                  "a:bf16", "a:f32", "c:u8/bf16", "c:u8/f32", "c:bf16/i8",
                                  "c:f32/i8",
                                  # the geometry layouts
                                  "a@coarse-octet", "a@unfolded", "a@four-level", "a@l1-nearest",
                                  "a@float", "a@float32", "c@coarse-octet", "c@unfolded",
                                  "c@four-level", "c@l1-nearest", "c@float", "a+e@l1-nearest",
                                  "a+b@128",
                                  # the (P, F) feature queried in bf16
                                  "a+b@bf16", "b+c@bf16", "b+c+d@bf16", "a+b@128-bf16"])
def test_form_kernel_matches_plain(name, P):
    form = {v: k for k, v in ps.FORMS.items()}[name]
    out = _kernel_vs_plain(form, P, _cuda())
    if form.occ and P > 1000:
        assert 0.3 < float(out[2].mean()) < 0.9


# keys beyond FORMS, each built from the key at its first launch: the view
# counts 1-8 of forms (a) and (c), and switch sets of every kind the
# renderer reaches (tests/test_torch_point_keys.py holds their plain
# version against the Pallas kernel)
KEY_CASES = [
    *(ps.Key(("i8",), "default", False, v) for v in (1, 2, 4, 5, 6, 7, 8)),
    *(ps.Key(("u8", "i8"), "default", False, v) for v in (2, 4, 8)),
    ps.Key(("i8",), "feats128", False, 8),
    ps.Key(("u8", "i8"), "coarse-octet", True),
    ps.Key(("bf16",), "default", True),
    ps.Key(("i8",), ((1, 32, "u8"), (8, 64, "i8")), False),
    ps.Key(("u8", "f32"), "l1-nearest", False),
    ps.Key(("f32",), "float32", True),
    ps.Key(("bf16", "i4"), "default", False),
    ps.Key(("u8", "bf16"), "default", True),
    ps.Key(("bf16",), "feats96", False),
    ps.Key(("bf16",), "feats96-bf16", False),
    ps.Key(("i8",), "feats128-bf16", False, 8),
    ps.Key(("f32", "i4"), "default", False),
    ps.Key(("f32",), "coarse-octet", False),
    ps.Key(("u8", "i8"), "four-level", True),
    ps.Key(("f32", "f32"), ((8, 32, "f32"), (8, 96, "f32")), True, 4),
]


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, 33, 257, 70001])
@pytest.mark.parametrize("key", KEY_CASES, ids=ps.form_name)
def test_key_kernel_matches_plain(key, P):
    _kernel_vs_plain(key, P, _cuda())


@pytest.mark.gpu
def test_kernel_refuses_forms_without_instantiation():
    """Every key the renderer forms builds (test_key_kernel_matches_plain);
    the entry refuses, before it launches, a key the source does not
    compile (occ_geom on a table 0 that is not the 32-channel level-1
    block, more views than a dataset chooses, a fifth geometry table) and
    inputs that do not fit the key (the packed weights of another F,
    cameras of another shape)."""
    from point_tables import seeded_tables

    dev = _cuda()
    before = sum(ps.LAUNCHES.values())
    args, kw = seeded_tables(FORM_A, 300, seed=0, device=dev)
    g0, g1 = kw["geom"]
    with pytest.raises(NotImplementedError, match="occ_geom needs"):
        ps.fused_point_stages_from_tables(*args, **{**kw, "geom": (g1, g0), "occ_geom": True})
    with pytest.raises(NotImplementedError, match="geometry tables"):
        ps.fused_point_stages_from_tables(*args, **{**kw, "geom": (g0, g0, g0, g0, g1)})
    quads, pts, KE = args[:3]
    nine = tuple((t.repeat(3, 1, 1, 1), sc) for t, sc in quads)
    with pytest.raises(NotImplementedError, match="9 views"):
        ps.fused_point_stages_from_tables(nine, pts, KE.repeat(3, 1, 1), *args[3:], **kw)
    args, kw = seeded_tables((("u8", "i8"), "feats96", False), 300, seed=0, device=dev)
    with pytest.raises(NotImplementedError, match="packed weights"):
        ps.fused_point_stages_from_tables(*args, **{**kw, "feats": kw["feats"][:, :64].contiguous()})
    with pytest.raises(NotImplementedError, match="cameras"):
        ps.fused_point_stages_from_tables(args[0], args[1], args[2][:, :3].contiguous(), *args[3:],
                                          **kw)
    assert sum(ps.LAUNCHES.values()) == before


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, *RAGGED, 640, 70001])
@pytest.mark.parametrize("case", ["a", "c", "a V2", "c V2", "a neg", "c neg", "a occ", "c occ",
                                  "b"])
def test_tables_kernel_matches_plain(case, P):
    """The entry (the kernel fetching its own rows) on the seeded tables
    and points of tests/point_tables.py (points off the images, behind a
    camera, on pixel and voxel edges, outside out_sh) of forms (a) and (c)
    at 3 and 2 views, in both ray conventions, with the occupancy cull, and
    of a form (b) key, against its plain version on the CPU, counted once
    per launch."""
    form, *opt = case.split()
    rows = ("u8", "i8") if form == "c" else ("i8",)
    key = ps.Key(rows, "feats96" if form == "b" else "default", "occ" in opt,
                 2 if "V2" in opt else 3)
    _kernel_vs_plain(key, P, _cuda(), neg_ray="neg" in opt)


@pytest.mark.gpu
def test_tables_kernel_refuses_what_it_does_not_take():
    """Tables the kernel does not fetch rows of, a quad table of another
    view count and an unknown device are refused before any launch."""
    from point_tables import seeded_tables

    from gpnerf_tpu_torch.ops.grid_sample import NearestTable

    dev = _cuda()
    args, kw = seeded_tables(FORM_A, device=dev)
    before = sum(ps.LAUNCHES.values())
    (t0, s0), (t1, s1) = kw["geom"]
    with pytest.raises(NotImplementedError, match="fetches rows of"):
        ps.fused_point_stages_from_tables(
            *args, **{**kw, "geom": ((t0, s0), (t1._replace(lerp_axes=1), s1))})
    quads = ((args[0][0][0][:2].contiguous(), args[0][0][1]),)
    with pytest.raises(NotImplementedError, match="quad table"):
        ps.fused_point_stages_from_tables(quads, *args[1:], **kw)
    assert isinstance(t1, NearestTable) and sum(ps.LAUNCHES.values()) == before


# the captured frames of the view cells' two render modes at 128^2
FRAME_CASES = {"fast": {}, "paper tables": dict(merge_lowres_src=False),
               "reference": dict(tight_cull=False, samples_per_ray=64, tap_window=0,
                                 merge_lowres_src=False, ray_cap=9216)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_tables_kernel_matches_plain_on_frame_inputs(case, monkeypatch):
    """The entry on the inputs a 128^2 render of the fast mode, of the
    paper configs' tables and of the reference semantics (the paper cell's
    blanket cull over 64 samples, form (c)) hands it, against its plain
    version, with the tolerances of test_kernel_matches_plain; the render
    fetches every slot in the kernel (`kernel_fetched_slots` =
    `point_slots` over a traced render)."""
    dev = _cuda()
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render import demo
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.utils import profiling

    cfg = _compaction_cfg("fast", **FRAME_CASES[case])
    r = load_eval_model(CKPT, get("render", "demo_render")(cfg, device=dev))
    calls = []
    real = demo.fused_point_stages_from_tables
    monkeypatch.setattr(demo, "fused_point_stages_from_tables",
                        lambda *a, **k: calls.append((a, k)) or real(*a, **k))
    batch = batch_to_device(_frame(cfg), dev)
    fn = r.render_demo_fn()
    fn(batch)
    assert len(calls) == 1
    args, kw = calls[0]
    P = args[4].shape[0]
    out = ps.fused_point_stages_from_tables(*args, **kw)
    _assert_kernel_near_plain(out, ps.point_stages_from_tables_plain(*args, **kw), P)
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        fn(batch)
        torch.cuda.synchronize()
    c = profiling.counters()
    assert c["kernel_fetched_slots"] == c["point_slots"] == P


# geometry-table switch settings of the fast mode -> the layout the fused
# path hands the kernel (float32 renders, as the CPU's)
GEOMETRY_CASES = {
    "coarse_nearest 0": (dict(coarse_nearest=0), "coarse-octet"),
    "fold_coarse_fc off": (dict(fold_coarse_fc=False), "unfolded"),
    "merge_coarse_octet off": (dict(merge_coarse_octet=False), "four-level"),
    "l1_nearest 2": (dict(l1_nearest=2), "l1-nearest"),
    "quantize_volume off": (dict(quantize_volume=False), "float32"),
    "pack_octet_u32": (dict(pack_octet_u32=True), "feats128"),
    "dense_conv": (dict(dense_conv=True), "default"),
    "l1_nearest 1, sigma_query_cull": (dict(l1_nearest=1, sigma_query_cull=True), "l1-nearest"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_geometry_layout_render_on_card_matches_cpu(case):
    """128^2 renders of a geometry-table switch on the card (its point-stage
    library) against the CPU (the plain version): the ray set and the ray
    and sample counts identical, the images within the fast mode's bounds."""
    dev = _cuda()
    from gpnerf_tpu_torch.config import cfg as base
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    tpu, layout = GEOMETRY_CASES[case]
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = cfg.dataset.W = 128
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.tpu.matmul_dtype = "float32"
    cfg.tpu.ray_cap = 16384
    for k, v in tpu.items():
        cfg.tpu[k] = v
    cfg.freeze()
    np.random.seed(0)
    random.seed(0)
    batch = get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    outs = {}
    for d in (dev, torch.device("cpu")):
        r = load_eval_model(CKPT, get("render", "demo_render")(cfg, device=d))
        assert r.kernel_form()[1] == layout
        before = dict(ps.LAUNCHES)
        outs[d.type] = {k: v.cpu() for k, v in r.render_demo_fn()(batch_to_device(batch, d)).items()}
        name = ps.FORMS[r.kernel_form()]
        assert ps.LAUNCHES[name] == before.get(name, 0) + (d.type == "cuda")
    g, c = outs["cuda"], outs["cpu"]
    assert torch.equal(g["mask_at_box"], c["mask_at_box"])
    assert torch.equal(g["counts"][:2], c["counts"][:2]) and torch.equal(g["overflows"], c["overflows"])
    assert abs(int(g["counts"][2]) - int(c["counts"][2])) <= 0.001 * int(c["counts"][2])
    m = g["mask_at_box"]
    d = (g["pred_chw"].reshape(3, -1)[:, m] - c["pred_chw"].reshape(3, -1)[:, m]).abs()
    assert float(d.median()) < 2e-3 and float((d > 0.05).float().mean()) <= 1e-3
    assert float(d.max()) < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fast", "reference", "frame_mode", "neg fast",
                                  "neg reference", "paper"])
def test_render_on_card_matches_cpu(mode):
    """128^2 renders on the card against the CPU; "neg" modes render the
    `thuman-synthetic` frame (THuman's neg-ray convention), whose ray masks
    and ray and sample counts must be identical on both devices; "paper" is
    the paper configs' table choice, split tables under the tight cull."""
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
    if mode == "paper":
        cfg.tpu.merge_lowres_src = False
    elif mode != "fast":
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
    assert float(d.max()) < (0.05 if mode in ("fast", "paper") else 0.15)


# --- the global sigma compaction (render/demo.py, dense_slots off)


def _compaction_cfg(mode, **tpu):
    """The 128^2 synthetic config of test_render_on_card_matches_cpu, fast
    mode or the reference mode with samples_per_ray 32 < 64."""
    from gpnerf_tpu_torch.config import cfg as base

    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = cfg.dataset.W = 128
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.tpu.matmul_dtype = "float32"
    cfg.tpu.ray_cap = 16384
    if mode == "reference K32":
        cfg.tpu.tight_cull = False
        cfg.tpu.samples_per_ray = 32
        cfg.tpu.tap_window = 0
        cfg.tpu.merge_lowres_src = False
        cfg.tpu.ray_cap = 9216
        cfg.tpu.sigma_cap = 327680
    for k, v in tpu.items():
        cfg.tpu[k] = v
    cfg.freeze()
    return cfg


def _frame(cfg):
    from gpnerf_tpu_torch.registry import get

    np.random.seed(0)
    random.seed(0)
    return get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fast", "reference K32"])
def test_kernel_matches_plain_on_compacted_points(mode, monkeypatch):
    """The point-stage kernel's entry on the inputs a compacted 128^2
    render hands it (P = sig_cap points: the valid slots, then a tail with
    sig_ok off), against its plain version, with the tolerances of
    test_kernel_matches_plain."""
    dev = _cuda()
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render import demo
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    cfg = _compaction_cfg(mode, dense_slots=False)
    r = load_eval_model(CKPT, get("render", "demo_render")(cfg, device=dev))
    calls = []
    real = demo.fused_point_stages_from_tables
    monkeypatch.setattr(demo, "fused_point_stages_from_tables",
                        lambda *a, **k: calls.append((a, k)) or real(*a, **k))
    ret = r.render_demo_fn()(batch_to_device(_frame(cfg), dev))
    assert len(calls) == 1 and int(ret["overflows"][2]) == 0
    args, kw = calls[0]
    sig_ok = args[4]
    P = sig_ok.shape[0]
    assert P == cfg.tpu.sigma_cap
    n = int(sig_ok.sum())
    assert 0 < n < P and not bool(sig_ok[n:].any())  # the tail is masked
    name = ps.FORMS[r.kernel_form()]
    before = ps.LAUNCHES[name]
    out = ps.fused_point_stages_from_tables(*args, **kw)
    torch.cuda.synchronize()
    assert ps.LAUNCHES[name] == before + 1
    out_p = ps.point_stages_from_tables_plain(*args, **kw)
    a, rgb, a_p, rgb_p = (t.cpu().numpy() for t in (*out[:2], *out_p[:2]))
    assert np.isfinite(a).all() and np.isfinite(rgb).all()
    assert not a[n:].any() and not rgb[n:].any()
    _assert_near(np.abs(a - a_p), P)
    agree = (a > 1e-14) == (a_p > 1e-14)
    assert (~agree).sum() <= max(1, 0.001 * P)
    _assert_near(np.abs(rgb - rgb_p)[agree], P)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fast", "reference K32"])
def test_compacted_render_on_card_equals_dense_slots(mode):
    """On the card, the compacted render of a 128^2 frame without a drop is
    the dense-slot render bit for bit (the kernel works point by point);
    with a cap that overflows, its integers equal the CPU's."""
    dev = _cuda()
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    batch = _frame(_compaction_cfg(mode))

    def render(d, **tpu):
        r = load_eval_model(CKPT, get("render", "demo_render")(_compaction_cfg(mode, **tpu),
                                                                device=d))
        return {k: v.cpu() for k, v in r.render_demo_fn()(batch_to_device(batch, d)).items()}

    dense, comp = render(dev), render(dev, dense_slots=False)
    assert int(comp["overflows"][2]) == 0
    for k in ("pred_chw", "overflows", "counts", "mask_at_box"):
        assert torch.equal(comp[k], dense[k]), k
    # 2 points per ray: below the frame's valid slots
    capped = dict(dense_slots=False, sigma_cap=2 * _compaction_cfg(mode).tpu.ray_cap)
    g, c = render(dev, **capped), render(torch.device("cpu"), **capped)
    assert int(g["overflows"][2]) > 0
    assert torch.equal(g["overflows"], c["overflows"]) and torch.equal(g["counts"][:2], c["counts"][:2])


# --- the windowed occupancy tap (render/demo.py, splat_bins off or tap_window under the blanket)

WINDOW_CASES = {
    # case -> (the switches over _compaction_cfg's mode, its kernel form)
    "fast": ("fast", dict(splat_bins=False), "a"),
    "frame_mode": ("fast", dict(splat_bins=False, frame_mode=True), "a+e"),
    "sigma_query_cull": ("fast", dict(splat_bins=False, sigma_query_cull=True), "a+e"),
    "compacted": ("fast", dict(splat_bins=False, dense_slots=False), "a"),
    "blanket W32": ("reference K32", dict(tap_window=32), "c"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_kernel_matches_plain_on_windowed_points(case, monkeypatch):
    """The point-stage kernel's entry on the inputs a windowed 128^2
    render hands it, against its plain version, with the tolerances of
    test_kernel_matches_plain; the render launches it once, under the
    key of its binned or windowless sibling."""
    dev = _cuda()
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render import demo
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    mode, tpu, form = WINDOW_CASES[case]
    cfg = _compaction_cfg(mode, **tpu)
    r = load_eval_model(CKPT, get("render", "demo_render")(cfg, device=dev))
    assert r._uses_window() and ps.form_name(r.kernel_form()) == form
    calls = []
    real = demo.fused_point_stages_from_tables
    monkeypatch.setattr(demo, "fused_point_stages_from_tables",
                        lambda *a, **k: calls.append((a, k)) or real(*a, **k))
    ps.LAUNCHES.clear()
    ret = r.render_demo_fn()(batch_to_device(_frame(cfg), dev))
    torch.cuda.synchronize()
    assert dict(ps.LAUNCHES) == {form: 1} and len(calls) == 1
    np.testing.assert_array_equal(ret["overflows"].cpu().numpy()[[0, 2, 3]], 0)
    args, kw = calls[0]
    P = args[4].shape[0]
    out = ps.fused_point_stages_from_tables(*args, **kw)
    out_p = ps.point_stages_from_tables_plain(*args, **kw)
    a, rgb, a_p, rgb_p = (t.cpu().numpy() for t in (*out[:2], *out_p[:2]))
    assert np.isfinite(a).all() and np.isfinite(rgb).all()
    _assert_near(np.abs(a - a_p), P)
    agree = (a > 1e-14) == (a_p > 1e-14)
    assert (~agree).sum() <= max(1, 0.001 * P)
    _assert_near(np.abs(rgb - rgb_p)[agree], P)
    if len(out) == 3:
        assert torch.equal(out[2], out_p[2])


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_windowed_render_on_card_matches_cpu(case):
    """A windowed 128^2 render on the card against the CPU's: the ray set,
    the overflows and the ray and sigma-slot counts equal, the image as in
    test_render_on_card_matches_cpu."""
    dev = _cuda()
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    mode, tpu, _ = WINDOW_CASES[case]
    cfg = _compaction_cfg(mode, **tpu)
    batch = _frame(cfg)
    outs = {}
    for d in (dev, torch.device("cpu")):
        r = load_eval_model(CKPT, get("render", "demo_render")(cfg, device=d))
        outs[d.type] = {k: v.cpu() for k, v in r.render_demo_fn()(batch_to_device(batch, d)).items()}
    g, c = outs["cuda"], outs["cpu"]
    for k in ("mask_at_box", "ray_pix_idx", "overflows"):
        assert torch.equal(g[k], c[k]), k
    assert torch.equal(g["counts"][:2], c["counts"][:2])
    assert abs(int(g["counts"][2]) - int(c["counts"][2])) <= 0.001 * int(c["counts"][2])
    m = g["mask_at_box"]
    d = (g["pred_chw"].reshape(3, -1)[:, m] - c["pred_chw"].reshape(3, -1)[:, m]).abs()
    assert float(d.median()) < 2e-3 and float((d > 0.05).float().mean()) <= 1e-3
    assert float(d.max()) < 0.15


# --- the mesh path (render_mesh of both renderers)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["BaseRender", "demo_render"])
def test_render_mesh_on_card_matches_cpu(name):
    """render_mesh of a 128^2 frame at a 0.02 m voxel on the card against
    the CPU: the same grid, alpha within 1e-4, a mesh on both."""
    dev = _cuda()
    from gpnerf_tpu_torch.config import cfg as base
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = cfg.dataset.W = 128
    cfg.head.sigma.code_dim = 32
    cfg.head.rgb.use_rgbhead = False
    cfg.dataset.voxel_size = [0.02, 0.02, 0.02]
    cfg.tpu.matmul_dtype = "float32"
    cfg.freeze()
    batch = _frame(cfg)
    outs = {}
    for d in (dev, torch.device("cpu")):
        r = load_eval_model(CKPT, get("render", name)(cfg, device=d)).eval()
        outs[d.type] = r.render_mesh(batch_to_device(batch, d), chunk=16384)
    g, c = outs["cuda"], outs["cpu"]
    assert g["cube"].shape == c["cube"].shape
    np.testing.assert_allclose(g["cube"], c["cube"], rtol=0, atol=1e-4)
    assert len(g["mesh"].faces) > 1000 and len(c["mesh"].faces) > 1000


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["BaseRender", "demo_render"])
def test_render_mesh_bf16_on_card_matches_cpu(name):
    """render_mesh of a 128^2 frame at a 0.02 m voxel under
    `tpu.matmul_dtype bfloat16` on the card against the CPU: the same grid;
    BaseRender (float32 in both packages there) alpha within 1e-4; the demo
    renderer's bf16 encoder and heads round where the devices' float32 sums
    straddle a bf16 boundary, so its alpha is held as the port's bf16 cube
    is held against JAX's (tests/test_torch_mesh.py: max 0.081, median
    4.7e-4 there): max within 0.15, median over the nonzero voxels within
    2e-3, a mesh on both (measured on the H100: BaseRender 4.9e-6; the
    demo renderer 0.084 and 4.1e-4)."""
    dev = _cuda()
    from gpnerf_tpu_torch.config import cfg as base
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = cfg.dataset.W = 128
    cfg.head.sigma.code_dim = 32
    cfg.head.rgb.use_rgbhead = False
    cfg.dataset.voxel_size = [0.02, 0.02, 0.02]
    cfg.tpu.matmul_dtype = "bfloat16"
    cfg.freeze()
    batch = _frame(cfg)
    outs = {}
    for d in (dev, torch.device("cpu")):
        r = load_eval_model(CKPT, get("render", name)(cfg, device=d)).eval()
        outs[d.type] = r.render_mesh(batch_to_device(batch, d), chunk=16384)
    g, c = outs["cuda"], outs["cpu"]
    assert g["cube"].shape == c["cube"].shape
    d = np.abs(g["cube"] - c["cube"])
    print(f"{name} bf16 mesh, card against CPU: max {d.max():.4g}, "
          f"median nonzero {np.median(d[c['cube'] > 0]):.4g}")
    if name == "BaseRender":
        assert d.max() <= 1e-4
    else:
        assert d.max() <= 0.15 and np.median(d[c["cube"] > 0]) <= 2e-3
    assert len(g["mesh"].faces) > 1000 and len(c["mesh"].faces) > 1000


# --- the quad-lerp kernels and the row gather (ops/quad_lerp.py, row_gather.py)


def _lerp_inputs(row_dtype, V, P, C, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    if row_dtype in (torch.float32, torch.bfloat16):
        rows = torch.randn(V * P, 4 * C, generator=g, device=dev).to(row_dtype)
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
@pytest.mark.parametrize("row_dtype", [torch.int8, torch.uint8, torch.float32, torch.bfloat16])
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
    assert float(d.max()) < (0.05 if mode in ("fast", "paper") else 0.15)


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


@pytest.mark.gpu
def test_bf16_train_step_on_card_matches_cpu():
    """One bf16 mixed-precision AdamW step (`tpu.train_dtype bfloat16`) of
    the training renderer at 128^2 from the trained checkpoint (ResNet34-
    UNet, code_dim 32, 256 rays x 16 samples), the same batch and draws on
    the card (cuDNN and cuBLAS bf16) and on the CPU. Where the devices'
    float32 sums straddle a bf16 boundary the two round apart, and the step
    amplifies that as it does any rounding detail (the JAX package's own
    bf16 gradient moves by 43% between two of its compile modes:
    tests/test_torch_bf16_train.py). Held: the loss within 1e-2 relative,
    rgb_map within 0.02, the whole gradient's cosine above 0.9 and norm
    ratio within 10%, every parameter, gradient and AdamW moment float32,
    the running statistics within 1e-3 (measured on the H100: 2.9e-3,
    9.7e-3, 0.991, 0.997, 1.3e-5)."""
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
    cfg.tpu.train_dtype = "bfloat16"
    cfg.freeze()
    np.random.seed(0)
    random.seed(0)
    batch = get("dataset", cfg.dataset.train.file)(cfg, is_train=True)[0]
    t_rand = torch.rand(256, 16, generator=torch.Generator().manual_seed(3))
    out = {}
    for d in (dev, torch.device("cpu")):
        r = load_eval_model(CKPT, get("render", "BaseRender")(cfg, device=d))
        opt, sched, _ = make_optimizer(r, cfg)
        metrics, ret = train_step(r, Criterion(cfg), opt, sched, batch_to_device(batch, d),
                                  t_rand=t_rand.to(d))
        for p in r.parameters():
            st = opt.state[p]
            assert p.dtype == p.grad.dtype == st["exp_avg"].dtype == torch.float32
        out[d.type] = {
            "loss": float(metrics["loss"]), "rgb": ret["rgb_map"].detach().float().cpu(),
            "grad": torch.cat([p.grad.double().reshape(-1).cpu() for p in r.parameters()]),
            "stats": {k: v.cpu() for k, v in r.state_dict().items() if "running" in k},
        }
    g, c = out["cuda"], out["cpu"]
    cos = float(g["grad"] @ c["grad"] / (g["grad"].norm() * c["grad"].norm()))
    ratio = float(g["grad"].norm() / c["grad"].norm())
    d_rgb = float((g["rgb"] - c["rgb"]).abs().max())
    d_stats = max(float((g["stats"][k] - v).abs().max()) for k, v in c["stats"].items())
    print(f"bf16 step, card against CPU: loss {g['loss']:.6f} / {c['loss']:.6f}, rgb_map max "
          f"{d_rgb:.3e}, gradient cosine {cos:.5f}, norm ratio {ratio:.5f}, running "
          f"statistics max {d_stats:.3e}")
    assert abs(g["loss"] - c["loss"]) <= 1e-2 * c["loss"]
    assert d_rgb <= 0.02 and cos > 0.9 and abs(ratio - 1.0) <= 0.1 and d_stats <= 1e-3


# --- the shipped tpu.matmul_dtype bfloat16 on real bf16 tensors, and the
# sequence entry (render/demo.py `render_demo_scan_fn`)


def _bf16_frames(n):
    from gpnerf_tpu_torch.registry import get

    cfg = _compaction_cfg("fast", matmul_dtype="bfloat16")
    np.random.seed(0)
    random.seed(0)
    ds = get("dataset", cfg.dataset.test.file)(cfg, is_train=False)
    return cfg, [ds[i] for i in range(n)]


@pytest.mark.gpu
def test_native_bf16_render_on_card_matches_cpu():
    """The fast mode under `tpu.matmul_dtype bfloat16` (the encoder, the
    sparse stack's operands and the heads on bf16 tensors), 128^2, on the
    card against the CPU: cuDNN's and the CPU's bf16 convolutions sum in
    other orders, so a feature map value lands one bf16 step apart here and
    there; the ray set and the counts agree as in the float32 test, the
    image within the bf16 gaps of tests/test_torch_native_bf16.py."""
    dev = _cuda()
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    cfg, (batch,) = _bf16_frames(1)
    outs = {}
    for d in (dev, torch.device("cpu")):
        r = load_eval_model(CKPT, get("render", "demo_render")(cfg, device=d))
        assert r.compute_dtype == torch.bfloat16
        outs[d.type] = {k: v.cpu() for k, v in r.render_demo_fn()(batch_to_device(batch, d)).items()}
    g, c = outs["cuda"], outs["cpu"]
    same = float((g["mask_at_box"] == c["mask_at_box"]).float().mean())
    m = g["mask_at_box"] & c["mask_at_box"]
    d = (g["pred_chw"].reshape(3, -1)[:, m] - c["pred_chw"].reshape(3, -1)[:, m]).abs()
    print(f"native bf16 128^2 card vs CPU: mask agreement {same:.6f}, counts "
          f"{g['counts'].tolist()} vs {c['counts'].tolist()}, |d pred| median "
          f"{float(d.median()):.3e} max {float(d.max()):.3e}")
    assert same > 0.999
    np.testing.assert_array_equal(g["overflows"].numpy()[[0, 2, 3]], 0)
    for k in (1, 2):
        assert abs(int(g["counts"][k]) - int(c["counts"][k])) <= 0.002 * int(c["counts"][k])
    assert float(d.median()) < 8e-3 and float((d > 0.05).float().mean()) <= 5e-3
    assert float(d.max()) < 0.15


@pytest.mark.gpu
def test_render_demo_scan_fn_on_card_matches_the_loop():
    """`render_demo_scan_fn` over a stack of two 128^2 frames in the order
    [0, 1, 0] on the card: its overflows and counts equal the per-frame
    renders', its checksums their sums."""
    dev = _cuda()
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.render.demo import stack_frames
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    cfg, host = _bf16_frames(2)
    frames = [batch_to_device(b, dev) for b in host]
    r = load_eval_model(CKPT, get("render", "demo_render")(cfg, device=dev))
    loop = [r.render_demo(f) for f in frames]
    out = r.render_demo_scan_fn()(stack_frames(frames), torch.tensor([0, 1, 0], device=dev))
    assert out["checksum"].device.type == "cuda"
    for i, f in enumerate((0, 1, 0)):
        assert torch.equal(out["overflows"][i], loop[f]["overflows"])
        assert torch.equal(out["counts"][i], loop[f]["counts"])
        want = loop[f]["pred_chw"].sum() + loop[f]["rgb_map"].sum() + loop[f]["mask_at_box"].sum()
        torch.testing.assert_close(out["checksum"][i], want, rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_bench_run_mode_on_card():
    """bench_torch.run_mode at 128^2 on the card over 2 bench frames (reps
    2, scan_cycles 2, iso_cycles 2): the scan's counters equal the loop's,
    every time is positive, the guard passes it, kernel 1 launches once per
    frame of a pass and the timer is the card's."""
    dev = _cuda()
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import bench_torch
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames

    cfg = bench_torch.bench_cfg(["dataset.H", "128", "dataset.W", "128", "tpu.ray_cap", "9216"])
    host = get_bench_frames(cfg, 2, verbose=False)
    r = load_eval_model(CKPT, get("render", cfg.render.file)(cfg, device=dev))
    rec = bench_torch.run_mode(r, cfg, reps=2, scan_cycles=2, iso_cycles=2, host=host)
    print({k: v for k, v in rec.items() if k not in ("loop_frames", "scan_frames")})
    assert rec["timer"] == "cuda events" and rec["device"] == "cuda"
    assert rec["scan_frames"]["overflows"] == rec["loop_frames"]["overflows"] * 2
    assert rec["scan_frames"]["counts"] == rec["loop_frames"]["counts"] * 2
    assert bench_torch.headline_guard(rec) == []
    times = [rec["ms_per_frame"], rec["loop_ms_per_frame"], rec["loop_dispatch_ms"],
             *rec["loop_reps_ms"], *rec["frame_ms_spread"]]
    assert all(t > 0 for t in times), times
    assert rec["launches"] == {"a": 2}


# --- the roofline's count (utils/roofline.py) on the card


@pytest.mark.gpu
def test_roofline_counts_transfers_apart():
    """A copy from the host to the card, and back, goes to transfer_bytes
    and is no device traffic."""
    dev = _cuda()
    from gpnerf_tpu_torch.utils.roofline import counting

    x = torch.randn(100, 100)
    with counting(dev) as c:
        y = x.to(dev)
        y.cpu()
    assert c.transfer_bytes == 2 * 100 * 100 * 4 and c.bytes == 0 and c.flops == 0


@pytest.mark.gpu
def test_roofline_count_on_card_matches_cpu():
    """Bench frame 0 at 128^2 through the fused fast render (bf16 as
    shipped), counted on the card and on the CPU: the same bytes and FLOPs
    (the kernel by its declared cost, the CPU's plain stand-ins as the
    card's calls), within 1% where a device branch differs."""
    dev = _cuda()
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import bench_torch
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames
    from gpnerf_tpu_torch.utils.roofline import counting

    cfg = bench_torch.bench_cfg(["dataset.H", "128", "dataset.W", "128", "tpu.ray_cap", "9216"])
    (host,) = get_bench_frames(cfg, 1, verbose=False)
    counts = {}
    for d in (dev, torch.device("cpu")):
        r = load_eval_model(CKPT, get("render", cfg.render.file)(cfg, device=d))
        with counting(d) as c:
            r.render_demo_fn()(batch_to_device(host, d))
        counts[d.type] = c
    g, c = counts["cuda"], counts["cpu"]
    diff = {k: g.by_op[k] - c.by_op[k] for k in set(g.by_op) | set(c.by_op)
            if g.by_op[k] != c.by_op[k]}
    print(f"128^2 count: card {g.bytes} B {g.flops} FLOPs, CPU {c.bytes} B {c.flops} FLOPs, "
          f"differing ops {diff}")
    assert g.kernels == c.kernels and dict(g.kernels) == {"point_stages": 1}
    assert abs(g.bytes - c.bytes) <= 0.01 * c.bytes and abs(g.flops - c.flops) <= 0.01 * c.flops
