"""The progressive switches the port's renderer takes beside the table choice
(gpnerf_tpu_torch/render/demo.py): `frame_mode`, `sigma_query_cull` and
`int4_feat` in the fast mode and in any subset in the reference mode,
`int4_feat` with `kernel_octet` off on the fused path, the paper configs'
`tpu` sections unchanged, and any switch set with any view count from 1 to
8 on the fused path (its kernel built from the key); the windowed tap
builds with the key of its binned or windowless sibling. The int4 feature table has no JAX render on the CPU (the JAX
package takes it on the TPU backend only, render/demo.py:1430-1434), so the
int4 render is held against the port's own int8 render; the renders are
128^2 frames of the synthetic scene with the trained checkpoint."""

import os
import random

import numpy as np
import pytest
import torch

from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.ops import point_stages as ps
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device
from gpnerf_tpu_torch.train.checkpoint import load_eval_model

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
H = W = 128
REF = dict(tight_cull=False, samples_per_ray=64, tap_window=0, merge_lowres_src=False,
           ray_cap=9216, sigma_cap=1048576, rgb_cap=262144)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Whole-frame renders under parallel test files (tests/test_torch_opbyop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(**tpu):
    cfg = port_cfg.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.dataset.H = H
    cfg.dataset.W = W
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.dataset.test.sampler = "FrameSampler"
    cfg.tpu.matmul_dtype = "float32"
    cfg.tpu.ray_cap = 16384
    for k, v in tpu.items():
        cfg.tpu[k] = v
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def renders():
    """switches -> the port's render of test frame 0 on the CPU, made once."""
    cfg = _cfg()
    np.random.seed(0)
    random.seed(0)
    batch = batch_to_device(port_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0],
                            "cpu")
    cache = {}

    def get(**tpu):
        key = tuple(sorted(tpu.items()))
        if key not in cache:
            r = port_get("render", "demo_render")(_cfg(**tpu), device="cpu")
            load_eval_model(CKPT, r)
            cache[key] = {k: v.numpy() for k, v in r.render_demo_fn()(batch).items()}
        return cache[key]

    return get


def test_frame_mode_is_inert_in_the_fast_mode(renders):
    """JAX takes the windowless frame only without splat bins
    (render/demo.py:459-461): with the tight cull's bins the fast mode
    renders the same with frame_mode on, bit for bit."""
    on, off = renders(frame_mode=True), renders()
    for k in off:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)


def test_dense_slots_off_composes_with_frame_mode(renders):
    """The global compaction (sigma_cap 294,912 above the frame's 212,992
    slots: nothing drops) with frame_mode, which the fast mode's bins leave
    inert: the default render, bit for bit."""
    comp, dense = renders(dense_slots=False, frame_mode=True), renders()
    assert comp["overflows"][2] == 0
    for k in dense:
        np.testing.assert_array_equal(comp[k], dense[k], err_msg=k)


def test_int4_split_tables_close_to_int8(renders):
    """Form c+d under the tight cull (split tables, the paper configs'
    choice) against the int8 render (c); the reference mode's int4 pairs are
    in tests/test_torch_refmode.py."""
    i4 = renders(merge_lowres_src=False, int4_feat=True)
    i8 = renders(merge_lowres_src=False)
    for k in ("mask_at_box", "overflows"):
        np.testing.assert_array_equal(i4[k], i8[k], err_msg=k)
    # n_sigma: the slots do not read the feature table
    np.testing.assert_array_equal(i4["counts"][:2], i8["counts"][:2])
    m = i8["mask_at_box"].reshape(H, W)
    diff = np.abs(i4["pred_chw"] - i8["pred_chw"])[:, m]
    # 15 levels per feature channel instead of 255 on a network trained
    # without them: the bounds of tests/test_torch_refmode.py's int4 render
    # (there: median 0.010, 99th percentile 0.110, max 0.263, 31.3 dB)
    assert 0 < np.median(diff) < 0.02, np.median(diff)
    assert np.percentile(diff, 99) < 0.15, np.percentile(diff, 99)
    assert diff.max() < 0.4, diff.max()
    assert -10 * np.log10(float(np.mean(diff ** 2))) > 29.0


@pytest.mark.parametrize("config", ["trainzju_valzju.yaml", "trainthu_valzju.yaml"])
def test_build_render_takes_the_paper_configs(config):
    """Each paper config's `tpu` section as it stands (its defaults: split
    tables under the tight cull) builds the progressive renderer, whose fused
    path launches form (c)."""
    cfg = port_cfg.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", config))
    cfg.merge_from_list(["render.file", "demo_render", "device", "cpu"])
    cfg.freeze()
    assert not cfg.tpu.merge_lowres_src and not cfg.tpu.merge_src_feat and cfg.tpu.tight_cull
    r = port_get("render", "demo_render")(cfg, device="cpu")
    assert r.kernel_form() == (("u8", "i8"), "default", False, 3)
    assert r.tight_cull and not r.merge_lowres_src


ACCEPTED = [
    # item 3a: inert switches; 3b: the query cull in the fast mode
    dict(frame_mode=True),
    dict(int4_feat=True),
    dict(merge_lowres_src=False, int4_feat=True),
    dict(sigma_query_cull=True),
    dict(merge_lowres_src=False, sigma_query_cull=True),
    dict(merge_lowres_src=False, sigma_query_cull=True, int4_feat=True),
    # 3c: pairs of the reference mode's variants
    dict(REF, frame_mode=True, sigma_query_cull=True),
    dict(REF, frame_mode=True, int4_feat=True),
    dict(REF, sigma_query_cull=True, int4_feat=True),
    dict(REF, frame_mode=True, sigma_query_cull=True, int4_feat=True),
    dict(REF, int4_feat=True, kernel_octet=False),
    dict(REF, frame_mode=True, int4_feat=True, kernel_octet=False),
    dict(merge_lowres_src=False, int4_feat=True, kernel_octet=False),
    # 3d: the table choice apart from the cull
    dict(REF, merge_lowres_src=True),
    dict(REF, merge_src_feat=True),
    dict(REF, quantize_proj=False),
    dict(merge_src_feat=True),
    dict(quantize_proj=False),
    dict(merge_lowres_src=False, quantize_proj=False),
    # the op-by-op stages take every form
    dict(merge_src_feat=True, sigma_query_cull=True, pallas_point=False),
    dict(REF, quantize_proj=False, frame_mode=True, pallas_point=False),
    # 3e: global compaction, and the blanket cull with K < S (frame_mode
    # then inert), tests/test_torch_sigma_compaction.py
    dict(dense_slots=False),
    dict(dense_slots=False, merge_lowres_src=False, sigma_query_cull=True),
    dict(REF, samples_per_ray=32),
    dict(REF, samples_per_ray=32, dense_slots=False, frame_mode=True),
    # 3g: the geometry-table layouts (tests/test_torch_geom_layouts.py)
    dict(quantize_volume=False),
    dict(merge_coarse_octet=False),
    dict(fold_coarse_fc=False),
    dict(coarse_nearest=0),
    dict(l1_nearest=1),
    dict(int4_coarse=True),
    dict(pack_octet_u32=True),
    dict(dense_conv=True),
    # combinations whose kernel key FORMS does not name: built from the key
    dict(merge_src_feat=True, sigma_query_cull=True),
    dict(REF, quantize_proj=False, frame_mode=True),
    dict(merge_src_feat=True, coarse_nearest=0),
]


@pytest.mark.parametrize("tpu", ACCEPTED)
def test_build_render_accepts_the_switch_combinations(tpu):
    r = port_get("render", "demo_render")(_cfg(**tpu), device="cpu")
    assert r.tight_cull == tpu.get("tight_cull", True)
    if r.pallas_point:
        assert ps.check_key(r.kernel_form()) == r.kernel_form()


@pytest.mark.parametrize(
    "tpu,key",
    [
        # 3f: the windowed tap without bins (ported since)
        (dict(splat_bins=False), "splat_bins"),
        (dict(REF, tap_window=16), "tap_window"),
    ],
)
def test_build_render_refuses_naming_the_key(tpu, key):
    """The windowed tap, refused until it was ported, builds: the window is
    on, and the kernel gets the key of the same tables with bins or without
    the window."""
    r = port_get("render", "demo_render")(_cfg(**tpu), device="cpu")
    assert r._uses_window() and not r._uses_bins()
    plain = dict(tpu, **{key: {"splat_bins": True, "tap_window": 0}[key]})
    assert r.kernel_form() == port_get("render", "demo_render")(
        _cfg(**plain), device="cpu").kernel_form()
    assert ps.check_key(r.kernel_form()) == r.kernel_form()


def test_build_render_refuses_other_view_counts():
    """The fused path takes 1 to 8 source views (the datasets choose at most
    8): V = 4 builds with pallas_point on, its key carries V and its heads
    flatten 4 views; V = 9 is refused naming src_view_num, and renders op by
    op."""
    cfg = _cfg()
    cfg.defrost()
    cfg.src_view_num = 4
    cfg.freeze()
    r = port_get("render", "demo_render")(cfg, device="cpu")
    assert r.pallas_point and r.kernel_form() == (("i8",), "default", False, 4)
    assert ps.form_name(r.kernel_form()) == "a@V4"
    assert r.nerfhead.rgbhead.rgb_fc[0].in_features == 4 * 32
    cfg.defrost()
    cfg.src_view_num = 9
    cfg.freeze()
    with pytest.raises(NotImplementedError, match="src_view_num"):
        port_get("render", "demo_render")(cfg, device="cpu")
    cfg.defrost()
    cfg.tpu.pallas_point = False
    cfg.freeze()
    port_get("render", "demo_render")(cfg, device="cpu")
