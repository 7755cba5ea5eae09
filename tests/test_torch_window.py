"""The windowed occupancy tap (gpnerf_tpu_torch/render/demo.py
`_window_start`, `_occupancy_tap`, `_ray_pipeline`; JAX render/demo.py
:293-322, :424-493, :520-580, :1532-1539, :1639) against the JAX package's
`render_demo_fn` on the same 128^2 synthetic frame with the trained
checkpoint, float32. On the CPU the JAX renderer runs its op-by-op point
stages and the port the plain version of its point-stage kernel (fused) or
its own op-by-op stages.

Cases: the fast mode without splat bins (the tap over the window of
`tap_window` 32 grid samples from each ray's front depth), with the dense
slots and compacted; the windowed `frame_mode`; `sigma_query_cull` on the
tap; the blanket cull with a real window (`tap_window` 16, K = 13); and
neg-ray, where the window is off and the tap walks all 64 samples from the
far end.

Held bitwise: the ray set, the overflow counters and the ray and sigma-slot
counts, and each ray's window start `s_lo`. The front-depth image `zmin`
to one float32 ulp: the compiled JAX program contracts the voxel-to-world
chain into fused multiply-adds, so some splatted voxels' camera depths
differ from the port's in the last bit. Colors: median <= 6e-4 over the
covered pixels and max <= 0.05 on every image row but the first and the
last; there at most two pixels beyond 0.05 (seen: 0.14, and 0.35 under
`sigma_query_cull`, which leaves the flipped sample more weight): the
target camera is source view 0's, so those rows' rays project onto its
row 0 or 127 to a float32 ulp, where the in-bounds test of a sample flips
(ROADMAP.md Queue 3 records the same rows for the other modes)."""

import os
import random

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
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device, src_norm
from gpnerf_tpu_torch.train.checkpoint import load_eval_model

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
H = W = 128
NEG = "thuman-synthetic"
# the fast mode's capacities of tests/test_torch_demo.py; the blanket cull's
# ray cap of tests/test_torch_refmode.py, sigma_cap K * R
FAST = dict(splat_bins=False, ray_cap=16384, sigma_cap=262144, rgb_cap=131072)
BLANKET = dict(tight_cull=False, tap_window=16, samples_per_ray=13, merge_lowres_src=False,
               ray_cap=9216, sigma_cap=119808, rgb_cap=131072)
CASES = {
    "fast": (False, FAST),
    "fast-compacted": (False, dict(FAST, dense_slots=False)),
    "frame-mode": (False, dict(FAST, frame_mode=True)),
    "sigma-query-cull": (False, dict(FAST, sigma_query_cull=True)),
    "blanket": (False, BLANKET),
    "neg-ray": (True, FAST),
}
PATHS = {"fused": {}, "op-by-op": dict(pallas_point=False)}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Whole-frame renders under parallel test files (tests/test_torch_opbyop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(base, neg=False, **tpu):
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
    for k, v in tpu.items():
        cfg.tpu[k] = v
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def batches():
    """neg -> the test frame, as the JAX package's data pipeline builds it."""
    out = {}
    for neg in (False, True):
        cfg = _cfg(jax_cfg, neg)
        np.random.seed(0)
        random.seed(0)
        out[neg] = jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    return out


@pytest.fixture(scope="module")
def jax_variables(batches):
    """The checkpoint's variables, loaded once (no switch here changes their
    tree) into a zero tree of `init_variables`' shapes: the strict load
    writes every leaf, and tracing the shapes skips the eager init."""
    jr = jax_get("render", "demo_render")(_cfg(jax_cfg))
    shapes = jax.eval_shape(lambda: jr.init_variables(0, batches[False]))
    return jax_load(CKPT, jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes), 4)


@pytest.fixture(scope="module")
def jax_renders(batches, jax_variables):
    """case -> the JAX render, made once."""
    cache = {}

    def get(case):
        if case not in cache:
            neg, tpu = CASES[case]
            r = jax_get("render", "demo_render")(_cfg(jax_cfg, neg, **tpu))
            ret = r.render_demo_fn()(jax_variables,
                                     {k: jnp.asarray(v) for k, v in batches[neg].items()})
            cache[case] = {k: np.asarray(v) for k, v in ret.items()}
        return cache[case]

    return get


def _port(neg, **tpu):
    r = port_get("render", "demo_render")(_cfg(port_cfg, neg, **tpu), device="cpu")
    load_eval_model(CKPT, r)
    return r


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", CASES)
def test_windowed_render_matches_jax(batches, jax_renders, case, path):
    neg, tpu = CASES[case]
    r = _port(neg, **tpu, **PATHS[path])
    assert r.neg_ray_val == neg and not r._uses_bins()
    # the window is off under neg-ray (every sample tapped, from the far end)
    assert r._uses_window() == (not neg)
    assert r._frame_mode_on() == (case == "frame-mode")
    pret = {k: v.numpy() for k, v in r.render_demo_fn()(batch_to_device(batches[neg], "cpu")).items()}
    jret = jax_renders(case)
    for k in ("mask_at_box", "ray_pix_idx", "ray_ok", "overflows"):
        np.testing.assert_array_equal(pret[k], jret[k], err_msg=k)
    np.testing.assert_array_equal(pret["counts"][:2], jret["counts"][:2])
    # colored points: near-zero densities cross the alpha boundary under the
    # kernel's bf16 dot inputs (0.2%, as tests/test_torch_sigma_compaction.py)
    assert abs(int(pret["counts"][2]) - int(jret["counts"][2])) <= 0.002 * jret["counts"][2]
    assert pret["overflows"][0] == pret["overflows"][2] == 0
    m = pret["mask_at_box"].reshape(H, W)
    assert m.sum() > 2000
    d = np.abs(pret["pred_chw"] - jret["pred_chw"])
    med = float(np.median(d[:, m]))
    assert med <= 6e-4, med
    assert d[:, 1:-1].max() <= 0.05, d[:, 1:-1].max()
    # the target camera is source view 0's: the first and last rows' rays
    # project onto its border rows, y = 0 or H - 1 to an ulp, where the
    # in-bounds test of a sample flips; at most two such pixels per frame
    b = batches[neg]
    np.testing.assert_array_equal(b["src_poses"][0], b["target_pose"])
    np.testing.assert_array_equal(b["src_Ks"][0], b["target_K"])
    big = np.argwhere(d.max(axis=0) > 0.05)
    assert set(big[:, 0]) <= {0, H - 1} and len(big) <= 2, big
    assert (pret["pred_chw"][:, ~m] == 0).all()


def psnr(pred_chw, batch):
    """PSNR over the mask_at_box pixels (train/evaluator.py semantics)."""
    pred = np.transpose(pred_chw, (1, 2, 0))
    n = int(batch["n_rays"])
    mask = np.asarray(batch["mask_at_box"]).reshape(pred.shape[:2])
    return float(-10.0 * np.log10(np.mean((pred[mask][:n] - np.asarray(batch["rgb"])[:n]) ** 2)))


def test_windowed_frame_mode_quality_follows_jax(batches, jax_renders):
    """The windowed frame_mode evaluates only the K grid samples from each
    ray's window start, where the tap keeps the first K occupied of W: in
    the JAX package's own semantics it renders below the windowed tap,
    and the port's PSNR is JAX's to 0.01 dB (at 384^2, `PYTHONPATH=.
    python tests/test_torch_window.py 384`: JAX 3.3 dB below the binned
    fast mode)."""
    b = batches[False]
    got = psnr(_port(False, **CASES["frame-mode"][1]).render_demo_fn()(
        batch_to_device(b, "cpu"))["pred_chw"].numpy(), b)
    want = psnr(jax_renders("frame-mode")["pred_chw"], b)
    assert abs(got - want) < 0.01, (got, want)
    assert want < psnr(jax_renders("fast")["pred_chw"], b)


def _jax_window(batch, variables, tpu):
    """JAX's per-ray front depth and window start, from its own frame stage
    inside one jitted program (the expressions of JAX render/demo.py
    :431-437 on its `rd`), and its raw splat depth image."""
    r = jax_get("render", "demo_render")(_cfg(jax_cfg, **tpu))
    seen = {}
    splat = r._splat_pixels

    def spy(*a):
        out = splat(*a)
        seen["zmin_img"] = out[1]
        return out

    r._splat_pixels = spy

    @jax.jit
    def run(variables, batch):
        featmaps = r.encoder.apply(variables["encoder"], jax_src_norm(batch["src_imgs"]))
        _, _, rd = r._frame_stage(variables, batch, featmaps)
        S, Wn = r.n_samples, max(r.tap_window, r.samples_per_ray)
        near, far, zmin = rd["near"], rd["far"], rd["zmin"]
        dz = jnp.maximum((far - near) / (S - 1), 1e-9)
        margin = r.window_margin_voxels * jnp.float32(r.voxel_size[0])
        s_lo = jnp.floor((zmin - margin - near) / dz).astype(jnp.int32)
        s_lo = jnp.where(zmin > 1e8, 0, jnp.clip(s_lo, 0, S - Wn))
        return {"zmin": zmin, "s_lo": s_lo, "zmin_img": seen["zmin_img"]}

    return {k: np.asarray(v) for k, v in run(variables, {k: jnp.asarray(v)
                                                         for k, v in batch.items()}).items()}


@pytest.mark.parametrize("case", ["fast", "blanket"])
def test_window_start_matches_jax(batches, jax_variables, case):
    """`s_lo` bitwise on every ray; the front depth (raw splat image and per
    ray, after the erosion) to one ulp, the no-voxel sentinel exactly."""
    _, tpu = CASES[case]
    jx = _jax_window(batches[False], jax_variables, tpu)
    r = _port(False, **tpu)
    b = batch_to_device(batches[False], "cpu")
    seen = {}
    splat = r._splat_pixels

    def spy(*a, **kw):
        out = splat(*a, **kw)
        seen["zmin_img"] = out[1]
        return out

    r._splat_pixels = spy
    with torch.no_grad():
        _, _, rd = r._frame_stage(b, r.encoder(src_norm(b["src_imgs"])))
        s_lo = r._window_start(rd, max(r.tap_window, r.samples_per_ray))
    np.testing.assert_array_equal(s_lo.numpy(), jx["s_lo"])
    assert 0 < s_lo.max() <= r.n_samples - max(r.tap_window, r.samples_per_ray)
    for k, pz in (("zmin", rd["zmin"]), ("zmin_img", seen["zmin_img"])):
        pz, jz = pz.numpy(), jx[k]
        np.testing.assert_array_equal(pz > 1e8, jz > 1e8, err_msg=k)
        np.testing.assert_array_max_ulp(pz, jz, maxulp=1)
    # most pixels the sentinel-free image covers agree to the bit
    near = jx["zmin_img"] < 1e8
    assert (seen["zmin_img"].numpy()[near] == jx["zmin_img"][near]).mean() > 0.95


@pytest.mark.parametrize(
    "tpu,form",
    [
        (dict(splat_bins=False), "a"),
        (dict(splat_bins=False, frame_mode=True), "a+e"),
        (dict(splat_bins=False, sigma_query_cull=True), "a+e"),
        (dict(tight_cull=False, tap_window=16, samples_per_ray=13, merge_lowres_src=False,
              frame_mode=True), "c+e"),
    ],
)
def test_windowed_modes_select_the_kernel_key(tpu, form):
    """The windowed paths hand kernel 1 the key of their binned siblings:
    (a) without bins, (a+e) in the windowed frame mode and under
    sigma_query_cull, (c+e) the paper tables' windowed frame."""
    r = port_get("render", "demo_render")(_cfg(port_cfg, **tpu), device="cpu")
    assert r._uses_window() and ps.form_name(r.kernel_form()) == form


if __name__ == "__main__":
    # PSNR of the JAX package's and the port's renders (CPU, float32, the
    # trained checkpoint) at size^2: the binned fast mode, the windowed tap
    # and its frame_mode. Usage, from the root of the repository:
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_window.py [size]
    import sys

    H = W = int(sys.argv[1]) if len(sys.argv) > 1 else 384
    torch.set_num_threads(4)
    cfg = _cfg(jax_cfg)
    np.random.seed(0)
    random.seed(0)
    frame = jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    jr = jax_get("render", "demo_render")(cfg)
    shapes = jax.eval_shape(lambda: jr.init_variables(0, frame))
    variables = jax_load(CKPT, jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes), 4)
    caps = dict(ray_cap=max(16384, H * W // 4))
    for name, tpu in (("binned fast mode", {}), ("windowed tap", dict(splat_bins=False)),
                      ("windowed frame_mode", dict(splat_bins=False, frame_mode=True))):
        r = jax_get("render", "demo_render")(_cfg(jax_cfg, **caps, **tpu))
        j = np.asarray(r.render_demo_fn()(variables, {k: jnp.asarray(v) for k, v in frame.items()})
                       ["pred_chw"])
        p = _port(False, **caps, **tpu).render_demo_fn()(batch_to_device(frame, "cpu"))
        print(f"{H}^2 {name}: PSNR JAX {psnr(j, frame):.3f} dB, port "
              f"{psnr(p['pred_chw'].numpy(), frame):.3f} dB", flush=True)
