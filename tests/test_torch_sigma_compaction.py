"""The globally compacted sigma path (`tpu.dense_slots False`: the valid
slots compacted slot-major to `sigma_cap` points, `sig_overflow` counted)
and the blanket cull with `samples_per_ray` < `n_samples`
(gpnerf_tpu_torch/render/demo.py `_ray_pipeline`; JAX render/demo.py
:560-644, :822-837) against the JAX package's `render_demo_fn` on the same
128^2 synthetic frame with the trained checkpoint, float32, in both ray
conventions (the `thuman-synthetic` fixture serves the neg-ray frame). On
the CPU the JAX renderer runs its op-by-op point stages and the port the
plain version of its point-stage kernel (fused) or its own op-by-op stages.

Held bitwise: the ray set, the overflow counters (`sig_overflow` among
them) and the ray and sigma-slot counts. The colored-point count and the
colors to the gaps ROADMAP.md records for the same mode: the colored points
within 0.2% (near-zero densities cross the alpha boundary under the
kernel's bf16 dot inputs; the JAX package's own float32 dense-slot and
compacted renders of the reference frame differ by 50 of 106,347), the
colors by their median and their largest difference. Also: without an
overflow the compacted render equals the dense-slot render bitwise; the
`cull_compact` stop; and the registry's encoder and head kinds in both
packages."""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render import demo as port_demo
from gpnerf_tpu_torch.render.base import batch_to_device
from gpnerf_tpu_torch.train.checkpoint import load_eval_model

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
H = W = 128
NEG = "thuman-synthetic"
MODES = {
    # the capacities of tests/test_torch_demo.py: sig_cap 262,144 above the
    # frame's K * R = 212,992 slots
    "fast": dict(ray_cap=16384, sigma_cap=262144, rgb_cap=131072),
    # the reference mode of tests/test_torch_refmode.py; sig_cap 327,680 lies
    # between the frame's 323,307 valid slots and its K * R = 589,824
    "reference": dict(tight_cull=False, samples_per_ray=64, tap_window=0,
                      merge_lowres_src=False, ray_cap=9216, sigma_cap=327680,
                      rgb_cap=262144),
}
COMPACT = dict(dense_slots=False)
# 2 points per ray: the fast frame's 62,604 valid slots overflow it
OVERFLOW = dict(dense_slots=False, sigma_cap=32768)
PATHS = {"fused": {}, "op-by-op": dict(pallas_point=False)}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Whole-frame renders under parallel test files (tests/test_torch_opbyop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(base, mode, neg=False, **tpu):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.dataset.H = H
    cfg.dataset.W = W
    if neg:
        cfg.dataset.test.name = NEG
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.dataset.test.sampler = "FrameSampler"
    cfg.tpu.matmul_dtype = "float32"
    cfg.tpu.eval_ray_cap = 16384
    cfg.tpu.eval_chunk = 4096
    for k, v in {**MODES[mode], **tpu}.items():
        cfg.tpu[k] = v
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def batches():
    """neg -> the test frame, as the JAX package's data pipeline builds it."""
    out = {}
    for neg in (False, True):
        cfg = _cfg(jax_cfg, "fast", neg)
        np.random.seed(0)
        random.seed(0)
        out[neg] = jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    assert (out[True]["near"][: int(out[True]["n_rays"])] < 0).all()
    return out


@pytest.fixture(scope="module")
def jax_renders(batches):
    """(mode, neg, switches) -> the JAX render, made once; the checkpoint's
    variables are loaded once (no switch here changes their tree)."""
    cache = {}
    jr = jax_get("render", "demo_render")(_cfg(jax_cfg, "fast"))
    variables = jax_load(CKPT, jr.init_variables(0, batches[False]), 4)

    def get(mode, neg=False, **tpu):
        key = (mode, neg, tuple(sorted(tpu.items())))
        if key not in cache:
            r = jax_get("render", "demo_render")(_cfg(jax_cfg, mode, neg, **tpu))
            assert r.neg_ray_val == neg
            ret = r.render_demo_fn()(variables,
                                     {k: jnp.asarray(v) for k, v in batches[neg].items()})
            cache[key] = {k: np.asarray(v) for k, v in ret.items()}
        return cache[key]

    return get


def _port(mode, neg=False, **tpu):
    r = port_get("render", "demo_render")(_cfg(port_cfg, mode, neg, **tpu), device="cpu")
    assert r.neg_ray_val == neg and r.dense_slots == tpu.get("dense_slots", True)
    load_eval_model(CKPT, r)
    return r


@pytest.fixture(scope="module")
def port_renders(batches):
    """(mode, neg, switches) -> the port's render on the CPU, made once."""
    cache = {}

    def get(mode, neg=False, **tpu):
        key = (mode, neg, tuple(sorted(tpu.items())))
        if key not in cache:
            ret = _port(mode, neg, **tpu).render_demo_fn()(batch_to_device(batches[neg], "cpu"))
            cache[key] = {k: v.numpy() for k, v in ret.items()}
        return cache[key]

    return get


def assert_matches_jax(pret, jret, mode):
    """Integers bitwise; colored points within 0.2%; the colors on the
    covered pixels: |d| median <= 5e-4 and max <= 0.025 (fast mode) or 0.05
    (reference mode) on every row but image row 0, held to 0.06. Row 0's
    rays project onto source row y = 0.0 to the last bit, where the rounding
    of the projection product flips a view's in-bounds test (recorded:
    reference 0.052, neg-ray fast 0.034). Returns (median, max)."""
    for k in ("mask_at_box", "ray_pix_idx", "ray_ok", "overflows"):
        np.testing.assert_array_equal(pret[k], jret[k], err_msg=k)
    np.testing.assert_array_equal(pret["counts"][:2], jret["counts"][:2])
    assert abs(int(pret["counts"][2]) - int(jret["counts"][2])) <= 0.002 * jret["counts"][2]
    assert pret["overflows"][0] == 0
    m = pret["mask_at_box"].reshape(H, W)
    assert m.sum() > 2000
    full = np.abs(pret["pred_chw"] - jret["pred_chw"])
    med, mx = float(np.median(full[:, m])), float(full.max())
    assert med <= 5e-4, med
    assert full[:, 1:].max() <= (0.025 if mode == "fast" else 0.05), full[:, 1:].max()
    assert mx <= 0.06, mx
    assert (pret["pred_chw"][:, ~m] == 0).all()
    return med, mx


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("neg", [False, True], ids=["positive", "neg-ray"])
@pytest.mark.parametrize("mode", MODES)
def test_compacted_render_matches_jax(jax_renders, port_renders, mode, neg, path):
    jret = jax_renders(mode, neg, **COMPACT)
    # drop-free: the compaction keeps every valid slot
    assert jret["overflows"][2] == 0
    assert_matches_jax(port_renders(mode, neg, **COMPACT, **PATHS[path]), jret, mode)


@pytest.mark.parametrize("path", PATHS)
def test_overflowing_sigma_cap_matches_jax(jax_renders, port_renders, path):
    """sig_cap = 32,768 below the frame's 62,604 valid slots: the compaction
    keeps the first slots of every ray and counts the rest."""
    jret = jax_renders("fast", **OVERFLOW)
    assert jret["overflows"][2] > 0
    assert jret["overflows"][2] == jret["counts"][1] - 32768
    pret = port_renders("fast", **OVERFLOW, **PATHS[path])
    assert_matches_jax(pret, jret, "fast")
    # the dropped slots lose color: fewer colored points than drop-free
    assert pret["counts"][2] < port_renders("fast", **COMPACT, **PATHS[path])["counts"][2]


@pytest.mark.parametrize("slots", ["dense", "compacted"])
def test_blanket_cull_with_fewer_slots_matches_jax(jax_renders, port_renders, slots):
    """K = 32 < S = 64 under the blanket cull: the tap walks all 64
    samples and the rank compaction keeps each ray's nearest 32."""
    tpu = dict(samples_per_ray=32, **(COMPACT if slots == "compacted" else {}))
    jret = jax_renders("reference", **tpu)
    assert jret["overflows"][1] > 0 and jret["overflows"][2] == 0
    assert_matches_jax(port_renders("reference", **tpu), jret, "reference")


def test_compacted_equals_dense_slots_without_overflow(port_renders):
    """The point stages work point by point and the compaction keeps every
    valid slot: the same image, bit for bit, and the same counts, here for
    the blanket cull with K = 32 (the fast mode's pair is in
    tests/test_torch_demo.py, the op-by-op pairs at 64^2 in
    tests/test_torch_opbyop_units.py)."""
    dense = port_renders("reference", samples_per_ray=32)
    comp = port_renders("reference", samples_per_ray=32, **COMPACT)
    assert comp["overflows"][2] == 0
    for k in ("pred_chw", "mask_at_box", "overflows", "counts"):
        np.testing.assert_array_equal(comp[k], dense[k], err_msg=k)


def test_cull_compact_stop(batches, monkeypatch):
    """`cull_compact` returns after the global compaction and the point
    recompute, before the point stages: its points are the dense frame's
    points of the valid slots in slot-major order, then a tail recomputed
    from the frame's last slot."""
    r = _port("fast", **COMPACT)
    b = batch_to_device(batches[False], "cpu")
    featmaps = r.encoder(port_demo.src_norm(b["src_imgs"]))
    seen, compacted = [], []
    real_pts, real_compact = port_demo.points_to_dhw_vox, port_demo._compact
    monkeypatch.setattr(port_demo, "points_to_dhw_vox",
                        lambda pts, *a: seen.append(pts) or real_pts(pts, *a))
    monkeypatch.setattr(port_demo, "_compact",
                        lambda mask, cap: compacted.append((mask, real_compact(mask, cap)))
                        or compacted[-1][1])
    monkeypatch.setattr(r, "_point_stages", None)  # a call would raise
    assert r._demo_impl(b, featmaps, stop_stage="cull_compact") is None
    valid, (idx, ok, overflow) = compacted[-1]  # the slots' compaction: the last
    stop_pts = seen.pop()
    r.dense_slots = True
    assert r._demo_impl(b, featmaps, stop_stage="cull_compact") is None
    dense_pts = seen.pop()
    n = int(valid.sum())
    assert stop_pts.shape[0] == 262144 > dense_pts.shape[0] == valid.shape[0] > n > 0
    assert overflow == 0
    np.testing.assert_array_equal(ok.numpy(), np.arange(262144) < n)
    np.testing.assert_array_equal(idx[:n].numpy(), np.flatnonzero(valid.numpy()))
    np.testing.assert_array_equal(stop_pts[:n].numpy(), dense_pts[valid].numpy())
    np.testing.assert_array_equal(stop_pts[n:].numpy(),
                                  dense_pts[-1:].expand(262144 - n, 3).numpy())


@pytest.mark.parametrize("kind", ["encoder", "head"])
@pytest.mark.parametrize("render", ["demo_render", "BaseRender"])
def test_unknown_encoder_or_head_file_raises_in_both_packages(kind, render):
    for base in (jax_cfg, port_cfg):
        cfg = _cfg(base, "fast")
        cfg.defrost()
        cfg[kind].file = "no_such_" + kind
        cfg.freeze()
        build = (jax_get if base is jax_cfg else port_get)("render", render)
        with pytest.raises(KeyError, match="no_such_" + kind):
            build(cfg) if base is jax_cfg else build(cfg, device="cpu")


def test_registry_resolves_the_reference_names_alike():
    for get in (jax_get, port_get):
        assert get("head", "BaseNeRFHead") is get("head", "trainhead")
        assert callable(get("encoder", "UNet"))
    cfg = _cfg(port_cfg, "fast")
    enc = port_get("encoder", cfg.encoder.file)(cfg, compute_dtype=torch.bfloat16)
    head = port_get("head", cfg.head.file)(cfg, compute_dtype=torch.bfloat16)
    assert enc.out_conv.compute_dtype == head.rgbhead.compute_dtype == torch.bfloat16
    assert head.spconv_out_dim == tuple(cfg.head.sigma.outdims)
