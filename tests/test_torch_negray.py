"""Slice-level parity of THuman's neg-ray convention in the port: scene
points at negative camera z, ray t-parameters negative, so ascending t runs
back to front (gpnerf_tpu_torch/render/demo.py and render/base.py).

The frames come from the `thuman-synthetic` fixture: the synthetic scene
served through OpenGL-convention cameras (data/synthetic_dataset.py), the
neg mode of the JAX package's bench. Compared at 128^2 with the trained
checkpoint, against the JAX package on the same host batch:

  * the progressive `render_demo_fn` in the fused fast mode, the fused
    reference mode, the op-by-op fast mode, and the reference mode with
    `frame_mode` set (inert under neg-ray in both packages: the render
    takes the tap and the dense slots). Integers bitwise; the colors within
    the bounds the positive-convention tests hold for the same mode;
  * BaseRender: the training loss of one batch with the same stratified
    draws, and the whole-image eval render;
  * the reference-mode render of the neg frame against the positive frame
    of the same scene (pixel-identical cameras): the flipped traversal
    keeps the same samples;
  * the demo render against BaseRender on the fabricated THuman tree of
    tests/test_dataset_fixtures.py (the port's twin of
    `test_thuman_demo_matches_base`)."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_dataset_fixtures import thuman_root  # noqa: F401  (a fixture)

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device, build_render
from gpnerf_tpu_torch.render.demo import pred_img_hwc
from gpnerf_tpu_torch.train.checkpoint import from_jax_variables, load_eval_model
from gpnerf_tpu_torch.train.criterion import Criterion

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
H = W = 128
MODES = {
    # the capacities of tests/test_torch_opbyop.py
    "fast": dict(ray_cap=16384, sigma_cap=262144, rgb_cap=131072),
    "reference": dict(tight_cull=False, samples_per_ray=64, tap_window=0,
                      merge_lowres_src=False, ray_cap=9216, sigma_cap=1048576,
                      rgb_cap=262144),
}
NEG = "thuman-synthetic"


def _cfg(base, mode, name=NEG, **tpu):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.dataset.H = H
    cfg.dataset.W = W
    cfg.dataset.test.name = name
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


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Whole-frame renders launch thousands of small torch ops; with the
    test files run in parallel, a thread per core for each op costs more
    than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _test_frame(name):
    cfg = _cfg(jax_cfg, "fast", name=name)
    np.random.seed(0)
    random.seed(0)
    return jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]


@pytest.fixture(scope="module")
def batch():
    b = _test_frame(NEG)
    n = int(b["n_rays"])
    assert (b["near"][:n] < 0).all() and (b["far"][:n] < 0).all()
    return b


@pytest.fixture(scope="module")
def jax_renders(batch):
    """(mode, switches) -> the JAX render of `batch`, made once."""
    cache = {}

    def get(mode, **tpu):
        key = (mode, tuple(sorted(tpu.items())))
        if key not in cache:
            jr = jax_get("render", "demo_render")(_cfg(jax_cfg, mode, **tpu))
            assert jr.neg_ray_val
            variables = jax_load(CKPT, jr.init_variables(0, batch), 4)
            ret = jr.render_demo_fn()(variables, {k: jnp.asarray(v) for k, v in batch.items()})
            cache[key] = {k: np.asarray(v) for k, v in ret.items()}
        return cache[key]

    return get


def _port_render(mode, b, name=NEG, **tpu):
    port = port_get("render", "demo_render")(_cfg(port_cfg, mode, name=name, **tpu),
                                             device="cpu")
    assert port.neg_ray_val == (name == NEG)
    load_eval_model(CKPT, port)
    ret = port.render_demo_fn()(batch_to_device(b, "cpu"))
    return {k: v.numpy() for k, v in ret.items()}


@pytest.fixture(scope="module")
def port_renders(batch):
    """(mode, switches) -> the port's render of `batch` on the CPU."""
    cache = {}

    def get(mode, **tpu):
        key = (mode, tuple(sorted(tpu.items())))
        if key not in cache:
            cache[key] = _port_render(mode, batch, **tpu)
        return cache[key]

    return get


# case -> (mode, switches, image bounds). The bounds are those the
# positive-convention tests hold for the same mode (tests/test_torch_demo.py,
# tests/test_torch_refmode.py, tests/test_torch_opbyop.py): |d pred_chw|
# over the covered pixels, (median, tail, max outside image row 0, max on
# row 0), and the share of colored points (alpha > 1e-14) that may differ.
# The tail is the 99.9th percentile of |d|, or for the float32 op-by-op
# mode the share of covered pixels whose |d| exceeds 1e-3. Measured on this
# frame:
#   fused fast: median 4.6e-4, 99.9th percentile 5.9e-3, max 0.016 / 0.034
#     on row 0, 4 of 45,254 colored points (the kernel's bf16 dot inputs
#     against JAX's float32 heads, as in the positive frame);
#   fused reference (and frame_mode, which renders the same): median 4.1e-4,
#     99.9th percentile 9.1e-3, max 0.016 / 0.083 on row 0, 78 of 106,316
#     (row 0: samples projecting onto source row y = 0.0 to the last bit
#     flip a view in or out);
#   op-by-op fast, float32 on both sides: median 2.8e-7, max 0.016 / 0.033
#     on row 0, 5 of 45,254. Its 99.9th percentile (5.7e-3) is wider than
#     the positive frame's (5.8e-4), which has no colored-point flip: each
#     flip moves one ray's color by up to 0.03, so the tail is bounded as
#     the share of pixels beyond 1e-3 (8 of 4,979 here, 4 in the positive
#     frame).
CASES = {
    "fused fast": ("fast", {}, (2e-3, ("p99.9", 0.01), 0.05, 0.05, 1e-3)),
    "fused reference": ("reference", {}, (2e-3, ("p99.9", 0.015), 0.05, 0.1, 1e-3)),
    "op-by-op fast": ("fast", {"pallas_point": False},
                      (5e-6, ("share>1e-3", 5e-3), 0.05, 0.05, 2e-4)),
    "reference frame_mode": ("reference", {"frame_mode": True},
                             (2e-3, ("p99.9", 0.015), 0.05, 0.1, 1e-3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_negray_render_matches_jax(jax_renders, port_renders, case):
    mode, tpu, (med, (tail, tail_max), mx, mx0, flips) = CASES[case]
    jret, pret = jax_renders(mode, **tpu), port_renders(mode, **tpu)
    # ray set, per-ray drops and tapped samples: integer pipelines over
    # identical float inputs
    for k in ("mask_at_box", "ray_pix_idx", "ray_ok", "overflows"):
        np.testing.assert_array_equal(pret[k], jret[k], err_msg=k)
    np.testing.assert_array_equal(pret["counts"][:2], jret["counts"][:2])
    # the blanket's AABB may differ in the last float32 bit (XLA fuses the
    # dense voxel walk into a multiply-add, tests/test_torch_refmode.py)
    np.testing.assert_allclose(pret["can_bounds"], jret["can_bounds"], rtol=0, atol=2e-7)
    ov = pret["overflows"]
    assert ov[0] == 0 and ov[2] == 0 and ov[3] == 0
    if mode == "reference":
        assert ov[1] == 0 and pret["counts"][1] > 300000
    else:
        assert ov[1] > 0  # the K = 13 slots drop far samples
    assert abs(int(pret["counts"][2]) - int(jret["counts"][2])) <= flips * jret["counts"][2]
    m = pret["mask_at_box"].reshape(H, W)
    assert m.sum() > 4000
    d = np.abs(pret["pred_chw"] - jret["pred_chw"])
    dm = d[:, m]
    assert np.median(dm) < med, np.median(dm)
    assert d[:, 1:].max() < mx, d[:, 1:].max()
    assert d[:, 0].max() < mx0, d[:, 0].max()
    if tail == "p99.9":
        assert np.percentile(dm, 99.9) < tail_max, np.percentile(dm, 99.9)
    else:
        assert (dm.max(axis=0) > 1e-3).mean() < tail_max, (dm.max(axis=0) > 1e-3).mean()
    assert (pret["pred_chw"][:, ~m] == 0).all()


def test_frame_mode_is_inert_under_negray(port_renders):
    """As in the JAX package, the windowless frame needs ascending traversal;
    under neg-ray `frame_mode` renders the tap and the dense slots."""
    a, b = port_renders("reference"), port_renders("reference", frame_mode=True)
    for k in ("pred_chw", "counts", "overflows", "mask_at_box"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_negray_reference_render_matches_positive_frame(port_renders):
    """The neg frame's cameras are the positive frame's, converted pixel
    for pixel: the reference mode walks the same blanket samples in the
    flipped order and composites them front to back, so the two images
    agree to float32 rounding of the sample positions (measured: median
    |d| 0, 99.9th percentile 1.5e-3, max 0.022, where a sample sits at the
    alpha boundary). The fast mode's bins dilate one way along the sample grid,
    so its neg cull keeps other samples than the positive one (the JAX
    package's design) and is not compared here."""
    neg = port_renders("reference")
    pos = _port_render("reference", _test_frame("synthetic"), name="synthetic")
    for k in ("mask_at_box", "ray_pix_idx", "overflows", "counts"):
        np.testing.assert_array_equal(neg[k][:2] if k == "counts" else neg[k],
                                      pos[k][:2] if k == "counts" else pos[k], err_msg=k)
    m = neg["mask_at_box"].reshape(H, W)
    d = np.abs(neg["pred_chw"] - pos["pred_chw"])[:, m]
    assert np.median(d) < 1e-6 and np.percentile(d, 99.9) < 5e-3 and d.max() < 0.05


# --- BaseRender ----------------------------------------------------------

def _small_cfg(base):
    """The size of tests/test_torch_train_step.py on the neg fixture."""
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.merge_from_list([
        "encoder.name", "tiny", "dataset.H", 128, "dataset.W", 128, "head.sigma.code_dim", 16,
        "train.n_rays", 256, "train.n_samples", 8, "tpu.eval_ray_cap", 4096,
        "tpu.eval_chunk", 1024, "dataset.train.name", NEG, "dataset.test.name", NEG])
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def base_pair():
    """JAX BaseRender with fresh variables, and the port's with the same
    variables carried across."""
    jc = _small_cfg(jax_cfg)
    random.seed(0)
    np.random.seed(0)
    train_b = jax_get("dataset", jc.dataset.train.file)(jc, is_train=True)[0]
    random.seed(0)
    np.random.seed(0)
    test_b = jax_get("dataset", jc.dataset.test.file)(jc, is_train=False)[0]
    jr = jax_get("render", "BaseRender")(jc)
    assert jr.neg_ray_train and jr.neg_ray_val
    jb = {k: jnp.asarray(v) for k, v in train_b.items()}
    variables = jax.tree.map(np.asarray, jax.jit(jr._init_variables_impl)(
        jax.random.PRNGKey(0), jb))
    port = build_render(_small_cfg(port_cfg), device="cpu")
    assert port.neg_ray_train and port.neg_ray_val
    return jc, jr, variables, port, train_b, test_b


def _carry(port, variables):
    """The JAX variables into the port (the train render moves the
    running statistics in place)."""
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return port


def test_base_train_loss_matches_jax(base_pair):
    """The training forward of one batch under neg-ray, with the same
    stratified draws, against the float32 JAX forward: the loss within
    1e-5 relative, as tests/test_torch_train_step.py holds it, and the
    per-ray colors within 1e-4. The JAX package sums its train-mode
    BatchNorm statistics in float32 and the port in float64, which puts
    the two forwards ~5e-6 apart in the loss and ~4e-5 in rgb_map on
    positive and neg batches alike (measured on three batches of each:
    1.3e-6 to 5.0e-6 positive, 4.7e-6 to 5.5e-6 neg)."""
    jc, jr, variables, port, b, _ = base_pair
    assert (b["near"][b["ray_valid"] > 0] < 0).all()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    rng = jax.random.PRNGKey(1)
    t_rand = np.array(jax.random.uniform(rng, (jc.train.n_rays, jc.train.n_samples)))
    jret, _ = jr.render_train(variables, jb, rng)
    crit = jax_get("criterion", jc.train.criterion_file)(jc)
    jl = float(sum(crit(jret, jb).values()))
    _carry(port, variables).train()
    pb = batch_to_device(b, "cpu")
    pret = port.render_train(pb, t_rand=torch.from_numpy(t_rand))
    pl = float(sum(Criterion(_small_cfg(port_cfg))(pret, pb).values()).detach())
    assert abs(pl - jl) <= 1e-5 * abs(jl), (pl, jl)
    np.testing.assert_allclose(pret["rgb_map"].detach().numpy(), np.asarray(jret["rgb_map"]),
                               atol=1e-4)
    assert int(pret["overflows"].max()) == 0


def test_base_eval_render_matches_jax(base_pair):
    """`render_eval` under neg-ray against JAX `render_eval_fn`, at the
    tolerances of the positive test (tests/test_torch_trainer.py)."""
    _, jr, variables, port, _, b = base_pair
    jout = jax.tree.map(np.asarray, jr.render_eval_fn()(variables,
                                                        {k: jnp.asarray(v) for k, v in b.items()}))
    _carry(port, variables).eval()
    pout = port.render_eval_fn()(batch_to_device(b, "cpu"))
    n = int(b["n_rays"])
    assert 0 < n <= b["ray_o"].shape[0]
    for k in ("rgb_map", "acc_map", "rgb_in_map"):
        np.testing.assert_allclose(pout[k].numpy()[:n], jout[k][:n], atol=1e-4, err_msg=k)
    # depths are negative t-parameters under neg-ray
    np.testing.assert_allclose(pout["depth_map"].numpy()[:n], jout["depth_map"][:n], rtol=1e-3,
                               atol=1e-4)
    assert float(pout["acc_map"][:n].max()) > 0.05
    assert float(pout["depth_map"][:n].min()) < 0


def test_thuman_demo_matches_base(thuman_root):  # noqa: F811
    """The port's progressive render (reference mode) against its BaseRender
    on the fabricated THuman tree, per pixel over the pixels both cover, at
    the bounds of the JAX package's twin (tests/test_dataset_fixtures.py:
    268): the demo's per-ray slots traverse front to back, which for neg
    rays is descending sample index."""
    cfg = port_cfg.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "trainthu_valzju.yaml"))
    for split in ("train", "test"):
        blk = cfg.dataset[split]
        blk.data_root = thuman_root
        blk.name = "thuman"
        blk.file = "CustomDataset"
    cfg.dataset.H = 256
    cfg.dataset.W = 256
    cfg.dataset.ratio = 0.5  # 256 -> 128
    cfg.render.file = "demo_render"
    cfg.tpu.matmul_dtype = "float32"
    # caps over the measured demand: ~2,400 demo rays and ~4,900 box rays
    for k, v in {**MODES["reference"], "ray_cap": 4096}.items():
        cfg.tpu[k] = v
    cfg.tpu.eval_ray_cap = 8192
    cfg.tpu.eval_chunk = 4096
    cfg.freeze()
    np.random.seed(0)
    random.seed(0)
    ds = port_get("dataset", "CustomDataset")(cfg, is_train=False)
    demo = load_eval_model(CKPT, port_get("render", "demo_render")(cfg, device="cpu"))
    base = load_eval_model(CKPT, build_render(cfg, device="cpu")).eval()
    assert demo.neg_ray_val and base.neg_ray_val
    for view in range(2):
        np.random.seed(view)
        random.seed(view)
        b = ds[0]  # one pose; the seeded RNG picks the fixed test view
        batch = batch_to_device(b, "cpu")
        dret = demo.render_demo_fn()(batch)
        ov = dret["overflows"].tolist()
        assert ov == [0, 0, 0, 0], ov
        bret = base.render_eval_fn()(batch)
        base_img = np.zeros((H * W, 3))
        idx = np.flatnonzero(b["mask_at_box"])
        n = int(b["n_rays"])
        base_img[idx[:n]] = bret["rgb_map"].numpy()[:n]
        covered = dret["mask_at_box"].numpy().reshape(H, W) & b["mask_at_box"].reshape(H, W)
        assert covered.sum() > 200, "demo should cover body pixels"
        diff = np.abs(pred_img_hwc(dret)[covered] - base_img.reshape(H, W, 3)[covered])
        assert np.median(diff) < 0.02, (view, float(np.median(diff)))
        assert (diff.max(axis=-1) < 0.1).mean() > 0.8, (view, (diff.max(axis=-1) < 0.1).mean())
