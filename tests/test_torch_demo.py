"""Slice-level parity: the port's fast-mode progressive render
(gpnerf_tpu_torch/render/demo.py) against the JAX package's
`render_demo_fn` on the same 128^2 synthetic frame with the trained
checkpoint. On the CPU the JAX renderer runs its op-by-op float32 point
stages (the Pallas megakernel is gated to the TPU backend) and the port runs
the plain version of its point-stage kernel (bf16 dot inputs, f32
accumulation), so the rendered colors agree to the kernel's bf16 numerics
while every integer output of the frame and ray stages agrees exactly."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.ops import point_stages as ps
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device
from gpnerf_tpu_torch.train.checkpoint import load_eval_model
from test_torch_datasets import same_host_kernels  # noqa: F401  (autouse: host-kernel route)

CKPT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "bench_ckpt.pth")
H = W = 128


def _cfg(base, **tpu):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = H
    cfg.dataset.W = W
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.dataset.test.sampler = "FrameSampler"
    cfg.tpu.matmul_dtype = "float32"
    # the capacities of tests/test_demo_consistency.py at 128^2
    cfg.tpu.ray_cap = 16384
    cfg.tpu.sigma_cap = 262144
    cfg.tpu.rgb_cap = 131072
    cfg.tpu.eval_ray_cap = 16384
    cfg.tpu.eval_chunk = 4096
    for k, v in tpu.items():
        cfg.tpu[k] = v
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def renders():
    jcfg = _cfg(jax_cfg)
    np.random.seed(0)
    random.seed(0)
    batch = jax_get("dataset", jcfg.dataset.test.file)(jcfg, is_train=False)[0]
    jr = jax_get("render", "demo_render")(jcfg)
    variables = jax_load(CKPT, jr.init_variables(0, batch), 4)
    jret = jr.render_demo_fn()(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    jret = {k: np.asarray(v) for k, v in jret.items()}

    port = port_get("render", "demo_render")(_cfg(port_cfg), device="cpu")
    load_eval_model(CKPT, port)
    pret = port.render_demo_fn()(batch_to_device(batch, "cpu"))
    pret = {k: v.numpy() for k, v in pret.items()}
    return jret, pret


def test_ray_set_and_overflows_match_exactly(renders):
    jret, pret = renders
    np.testing.assert_array_equal(pret["mask_at_box"], jret["mask_at_box"])
    np.testing.assert_array_equal(pret["ray_pix_idx"], jret["ray_pix_idx"])
    np.testing.assert_array_equal(pret["ray_ok"], jret["ray_ok"])
    np.testing.assert_array_equal(pret["can_bounds"], jret["can_bounds"])
    # [ray, per-ray-K, sigma, rgb] overflows: the splat bins and the K-slot
    # compaction are integer pipelines over identical float inputs
    np.testing.assert_array_equal(pret["overflows"], jret["overflows"])
    assert pret["overflows"][0] == 0 and pret["overflows"][1] > 0


def test_counts_match(renders):
    jret, pret = renders
    # rays and sigma slots: exact
    np.testing.assert_array_equal(pret["counts"][:2], jret["counts"][:2])
    # colored points (alpha > 1e-14): the port's kernel rounds dot inputs
    # to bf16 where the JAX CPU path runs float32, which moves near-zero
    # densities across the ReLU/alpha boundary for a few points (14 of
    # 52,209 measured); bound the flips at 0.1%
    assert abs(int(pret["counts"][2]) - int(jret["counts"][2])) <= 0.001 * jret["counts"][2]


def test_image_matches_on_covered_pixels(renders):
    jret, pret = renders
    m = pret["mask_at_box"].reshape(H, W)
    assert m.sum() > 2000
    diff = np.abs(pret["pred_chw"] - jret["pred_chw"])[:, m]
    # bf16 dot inputs through 4+5 MLP layers perturb each sample's color and
    # alpha by ~1e-3 (tests/test_pallas_point.py bounds); measured median
    # 4.6e-4, 99.9th percentile 3.0e-3, max 0.023 over 4,979 rays
    assert np.median(diff) < 2e-3, np.median(diff)
    assert np.percentile(diff, 99.9) < 0.01, np.percentile(diff, 99.9)
    assert diff.max() < 0.05, diff.max()
    assert (pret["pred_chw"][:, ~m] == 0).all()


def test_port_render_is_deterministic(renders):
    _, pret = renders
    cfg = _cfg(port_cfg)
    np.random.seed(0)
    random.seed(0)
    batch = port_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    port = port_get("render", "demo_render")(cfg, device="cpu")
    load_eval_model(CKPT, port)
    again = port.render_demo_fn()(batch_to_device(batch, "cpu"))
    # the port's own data copy builds the same frame, and the render is
    # bitwise reproducible
    np.testing.assert_array_equal(again["pred_chw"].numpy(), pret["pred_chw"])
    np.testing.assert_array_equal(again["counts"].numpy(), pret["counts"])


@pytest.mark.parametrize(
    "key,value",
    [("l1_nearest", 1), ("splat_bins", False),
     ("quantize_volume", False), ("coarse_nearest", 0),
     ("int4_coarse", True)],
)
def test_switches_outside_fast_mode_raise(key, value):
    # switches refused by earlier slices build now: the windowed tap
    # (splat_bins off under the tight cull) hands the kernel the binned
    # fast mode's key (tests/test_torch_window.py holds its renders against
    # JAX); the geometry-table switches beside merged float32 rows
    # (merge_src_feat), refused while the point-stage kernel had a closed
    # table of libraries, build: the kernel is built for the key they select
    if key == "splat_bins":
        r = port_get("render", "demo_render")(_cfg(port_cfg, **{key: value}), device="cpu")
        assert r._uses_window() and not r._uses_bins() and r.tap_window == 32
        assert ps.form_name(r.kernel_form()) == "a"
        return
    r = port_get("render", "demo_render")(
        _cfg(port_cfg, **{key: value}, merge_src_feat=True), device="cpu")
    assert r.pallas_point and getattr(r, key) == value
    assert ps.check_key(r.kernel_form()) == r.kernel_form() and r.kernel_form() not in ps.FORMS


def test_dense_slots_off_renders_the_dense_frame(renders):
    """`dense_slots False` compacts the valid slots globally to sigma_cap
    (262,144, above this frame's 212,992 slots): nothing drops, and the
    render is the dense-slot render bit for bit, whose integers are JAX's."""
    jret, pret = renders
    cfg = _cfg(port_cfg, dense_slots=False)
    np.random.seed(0)
    random.seed(0)
    batch = port_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    port = port_get("render", "demo_render")(cfg, device="cpu")
    assert not port.dense_slots
    load_eval_model(CKPT, port)
    comp = {k: v.numpy() for k, v in port.render_demo_fn()(batch_to_device(batch, "cpu")).items()}
    assert comp["overflows"][2] == 0
    for k in ("pred_chw", "mask_at_box", "ray_pix_idx", "overflows", "counts"):
        np.testing.assert_array_equal(comp[k], pret[k], err_msg=k)
    np.testing.assert_array_equal(comp["overflows"], jret["overflows"])
