"""Neural Body in the port (models/neural_body.py, render/neural_body.py,
the generalised sparse stack of models/sparse_net.py and
ops/compositing.py's `raw2outputs_distance`) against its plain reference
(benchmark/reference/nbody/), on the CPU.

A small cut: code width 8, level widths (8, 16, 32, 32) with (2, 2, 3, 3,
3) convs, MLP width 64 (32 after the view), latent width 16, 16 samples a
ray, one 64^2 view of the frozen synthetic performer at 2 cm voxels;
seeded weights with BatchNorm statistics away from (0, 1).

  * the four volumes (and the active sites) equal the reference's, float32;
  * the raw rgb and sigma of random points equal the reference's, float32;
  * the whole image equals the reference's in float32 and is within the
    bf16 tolerance below in the configuration's precision; a profiled
    render holds its four spans and counts every sample;
  * the published shapes, without a forward pass;
  * sigma does not depend on the latent row or the view direction, rgb
    does;
  * GP-NeRF's sparse stack keeps its parameter names and its outputs bit
    for bit against the frozen copy the benchmark keeps of it.
"""

import copy
import itertools
import os
import sys

import numpy as np
import pytest
import torch

from benchmark import pool
from benchmark.reference import nbody as ref
from benchmark.reference.eager.models import sparse_net as frozen_sparse_net
from benchmark.reference.eager.ops import sparse_conv as frozen_sparse_conv
from gpnerf_tpu_torch.data.base import HumanNVSDataset
from gpnerf_tpu_torch.data.sparse_host import build_host_pyramid
from gpnerf_tpu_torch.models.neural_body import NeuralBody, encoding_dim, positional_encoding
from gpnerf_tpu_torch.models.sparse_net import SparseConvNet, sparse_net_dense_eval
from gpnerf_tpu_torch.ops.sparse_conv import SparseLevel
from gpnerf_tpu_torch.render.base import batch_to_device, points_to_dhw_vox
from gpnerf_tpu_torch.render.neural_body import NeuralBodyRender, frame_levels
from gpnerf_tpu_torch.utils import profiling

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_nbody_ckpt  # noqa: E402

NB = {"n_smpl": 6890, "code_dim": 8, "out_dim": [8, 16, 32, 32], "convs": [2, 2, 3, 3, 3],
      "width": 64, "view_width": 32, "latent_dim": 16, "num_train_frame": 30, "xyz_res": 10,
      "view_res": 4, "n_samples": 16}
VOXEL = (0.02, 0.02, 0.02)
MAX_OUT_SH = (32, 96, 64)
CFG = {"cam_num": 3, "src_view_num": 3, "mask_bkgd": True,
       "dataset": {"H": 64, "W": 64, "ratio": 1.0, "voxel_size": list(VOXEL)},
       "train": {"n_rays": 1024, "n_samples": 16, "body_sample_ratio": 0.5},
       "tpu": {"max_out_sh": list(MAX_OUT_SH), "site_cap": 4096,
               "level_caps": [2048, 1024, 512, 256], "eval_ray_cap": 4096}}
SEED = 2**31 + 2601
# bf16 operands in every conv and Linear layer against float32 (measured
# at this cut over the lit pixels: median 7.5e-4, 99th percentile 9.6e-3,
# RMSE 4.0e-2): bf16 keeps 8 significant bits, and sigma's error is about
# 1% of its range. A ray whose last sample reads sigma within that of 0
# turns opaque there in one precision and not the other (the source's
# 1e10 spacing after the last sample) and moves its pixel by as much as
# its remaining transmittance: 0.6% of this cut's rays (coarse 32 cm
# voxels reach far past the body). So the 99th percentile is held to 2e-2
# and the RMSE, which those rays set, to 8e-2.
BF16_P99, BF16_RMSE = 2e-2, 8e-2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _program(compute_dtype=None, nb=NB):
    net = NeuralBody(n_smpl=nb["n_smpl"], code_dim=nb["code_dim"], out_dim=nb["out_dim"],
                     convs=nb["convs"], width=nb["width"], view_width=nb["view_width"],
                     latent_dim=nb["latent_dim"], num_train_frame=nb["num_train_frame"],
                     xyz_res=nb["xyz_res"], view_res=nb["view_res"],
                     compute_dtype=compute_dtype)
    return NeuralBodyRender(net, voxel_size=VOXEL, max_out_sh=MAX_OUT_SH,
                            n_samples=nb["n_samples"], chunk_rays=256)


def _seeded_state(seed, hb):
    """Weights at Kaiming scale, BatchNorm affines and running statistics
    away from (0, 1), biases nonzero; alpha_fc set by the checkpoint
    maker (tools/make_nbody_ckpt.py `set_alpha`, through the reference) on
    the case's frame: the body partly opaque (mean opacity 0.6 over the
    rays that meet it) and empty space at sigma -8."""
    g = torch.Generator().manual_seed(seed)
    model = ref.NeuralBody(NB)
    state = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            state[name] = t
        elif name.endswith("running_var"):
            state[name] = 0.5 + torch.rand(t.shape, generator=g)
        elif name.endswith("running_mean") or (name.endswith("bias") and "xyzc" in name):
            state[name] = 0.2 * torch.randn(t.shape, generator=g)
        elif "xyzc" in name and t.dim() == 1:
            state[name] = 1.0 + 0.2 * torch.randn(t.shape, generator=g)
        elif t.dim() == 5:
            state[name] = torch.randn(t.shape, generator=g) * (2.0 / (27 * t.shape[3])) ** 0.5
        elif name in ("net.c.weight", "net.latent.weight"):
            state[name] = torch.randn(t.shape, generator=g)
        elif t.dim() == 2:
            state[name] = torch.randn(t.shape, generator=g) * (2.0 / t.shape[1]) ** 0.5
        else:
            state[name] = 0.05 * torch.randn(t.shape, generator=g)
    model.load_state_dict(state)
    make_nbody_ckpt.set_alpha(model.eval(), hb, VOXEL, NB["n_samples"], 0.6, -8.0)
    return copy.deepcopy(model.state_dict())


@pytest.fixture(scope="module")
def case():
    """(host batch, uploaded batch, the seeded state, the reference's
    model) of one 64^2 view."""
    scene = pool.new_scene(CFG)
    poses, cams = pool.view_items(SEED, 2, pool.img_hw(CFG))
    ds = pool.make_dataset(HumanNVSDataset, scene, poses, cams, "test", CFG)
    hb = pool.build_batches(ds, SEED, [0], pool.VIEW_TAG)[0]
    assert not hb["pyramid_overflows"].any()
    batch = batch_to_device(hb, torch.device("cpu"))
    state = _seeded_state(SEED, hb)
    model = ref.NeuralBody(NB)
    model.load_state_dict(state, strict=True)
    return hb, batch, state, model.eval()


def _loaded(state, compute_dtype=None):
    prog = _program(compute_dtype)
    prog.load_state_dict(state, strict=True)
    return prog.eval()


def test_volumes_and_active_sites_match_the_reference(case):
    hb, batch, state, model = case
    prog = _loaded(state)
    levels = frame_levels(batch, MAX_OUT_SH)
    with torch.no_grad():
        vols = prog.net.volumes(batch["vertex_rows"], levels, hb["out_sh"])
        ref_vols, masks = ref.volumes(model.net, hb, torch.device("cpu"))
    assert [int(lv.valid.sum()) for lv in levels] == [int(m.sum()) for m in masks]
    for v, r in zip(vols, ref_vols):
        assert float(r.abs().max()) > 0.1
        torch.testing.assert_close(v, r[0], rtol=1e-5, atol=1e-5)


def _random_points(hb, n, seed):
    g = torch.Generator().manual_seed(seed)
    lo, hi = (torch.as_tensor(hb["can_bounds"][k]) for k in (0, 1))
    pts = lo + (hi - lo) * torch.rand(n, 3, generator=g)
    dirs = torch.randn(n, 3, generator=g)
    return pts, dirs


def _program_raw(prog, batch, vols, pts, dirs, latent=None):
    net = prog.net
    feat = net.query(vols, points_to_dhw_vox(pts, batch, VOXEL), batch["out_sh"])
    view_enc, xyz_enc = net.encodings(pts, dirs / dirs.norm(dim=-1, keepdim=True))
    lat = net.latent_row(batch["latent_index"]) if latent is None else latent
    return net.head(feat, lat, view_enc, xyz_enc)


def test_raw_of_random_points_matches_the_reference(case):
    hb, batch, state, model = case
    prog = _loaded(state)
    pts, dirs = _random_points(hb, 2048, 1)
    with torch.no_grad():
        vols = prog.net.volumes(batch["vertex_rows"], frame_levels(batch, MAX_OUT_SH),
                                    batch["out_sh"])
        got = _program_raw(prog, batch, vols, pts, dirs)
        ref_vols, _ = ref.volumes(model.net, hb, torch.device("cpu"))
        want = ref.raw(model.net, ref_vols, ref.Frame(hb, torch.device("cpu")), pts, dirs, VOXEL)
    # the points meet the body and empty space alike
    assert 0.05 < float((want[:, 3] > 0).float().mean()) < 0.95
    # 1e-5 of each channel's range (alpha_fc scales sigma's)
    scale = want.abs().amax(dim=0)
    torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=1e-5)


def test_image_matches_the_reference_and_counts_every_sample(case, tmp_path):
    hb, batch, state, model = case
    want = ref.render_batch(model, hb, dict(NB), VOXEL, torch.device("cpu"))
    prog = _loaded(state)
    profiling.reset_counters()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            ret = prog.render_demo_fn()(batch)
        counted = profiling.counters()
    finally:
        profiling.reset_counters()
    spans = {e.name for e in prof.events()}
    assert {"nbody.render", "nbody.volume", "nbody.points", "nbody.composite"} <= spans
    assert counted["nbody_points"] == want["points"] == int(hb["n_rays"]) * NB["n_samples"]
    assert counted["nbody_rays"] == int(hb["n_rays"])
    img = ret["pred_chw"].permute(1, 2, 0).numpy()
    assert 0.05 < float(img.std()) and float(img.max()) > 0.3
    np.testing.assert_allclose(img, want["image"], rtol=1e-5, atol=1e-5)

    with torch.no_grad():
        bf = _loaded(state, torch.bfloat16).render_demo_fn()(batch)["pred_chw"]
    d = bf.permute(1, 2, 0).numpy().astype(np.float64) - want["image"]
    assert np.sqrt(np.mean(d * d)) < BF16_RMSE
    assert np.quantile(np.abs(d[want["image"].any(axis=-1)]), 0.99) < BF16_P99
    assert np.abs(d).max() > 0  # the bf16 path rounds


def test_published_shapes():
    net = NeuralBody()
    assert positional_encoding(torch.zeros(5, 3), 10).shape == (5, 63) == (5, encoding_dim(10))
    assert positional_encoding(torch.zeros(5, 3), 4).shape == (5, 27) == (5, encoding_dim(4))
    mlp = ("fc_0", "fc_1", "fc_2", "alpha_fc", "feature_fc", "latent_fc", "view_fc", "rgb_fc")
    assert sum(p.numel() for n, p in net.named_parameters() if n.split(".")[0] in mlp) == 431364
    shapes = {n: tuple(getattr(net, n).weight.shape) for n in mlp}
    assert shapes == {"fc_0": (256, 352), "fc_1": (256, 256), "fc_2": (256, 256),
                      "alpha_fc": (1, 256), "feature_fc": (256, 256), "latent_fc": (256, 384),
                      "view_fc": (128, 346), "rgb_fc": (3, 128)}
    assert [len(net.xyzc_net.net[2 * i]) // 3 for i in range(5)] == [2, 2, 3, 3, 3]
    assert tuple(net.c.weight.shape) == (6890, 16)
    widths = [net.xyzc_net.net[2 * i][0].weight.shape[-1] for i in range(5)]
    assert widths == [16, 32, 64, 128, 128]
    assert sum(p.numel() for p in net.parameters()) == 4336036


def test_sigma_ignores_latent_and_view_but_rgb_does_not(case):
    hb, batch, state, model = case
    prog = _loaded(state)
    pts, dirs = _random_points(hb, 1024, 2)
    _, dirs2 = _random_points(hb, 1024, 3)
    with torch.no_grad():
        vols = prog.net.volumes(batch["vertex_rows"], frame_levels(batch, MAX_OUT_SH),
                                    batch["out_sh"])
        base = _program_raw(prog, batch, vols, pts, dirs)
        other_latent = _program_raw(prog, batch, vols, pts, dirs, prog.net.latent.weight[[7]])
        other_view = _program_raw(prog, batch, vols, pts, dirs2)
    for other in (other_latent, other_view):
        assert torch.equal(other[:, 3], base[:, 3])
        assert (other[:, :3] - base[:, :3]).abs().max() > 1e-2
    # an index past the trained frames takes the last row
    assert torch.equal(prog.net.latent_row(torch.tensor(99)), prog.net.latent.weight[[29]])


def _pyramid(seed):
    rng = np.random.default_rng(seed)
    coord = rng.integers(0, (16, 32, 32), size=(900, 3))
    return build_host_pyramid(coord, (16, 32, 32), 1024, (1024, 512, 256, 128))


@pytest.mark.parametrize("seed", [0, 1])
def test_gpnerf_sparse_stack_keeps_its_names_and_outputs(seed):
    """GP-NeRF's instance against the benchmark's frozen copy of the stack
    before it took a conv count per level: the same state-dict keys and
    bitwise the same `features` and `sparse_net_dense_eval`."""
    new = SparseConvNet(in_dim=32, out_dim=(32, 32, 32, 32))
    old = frozen_sparse_net.SparseConvNet(in_dim=32, out_dim=(32, 32, 32, 32))
    assert list(new.state_dict()) == list(old.state_dict())
    g = torch.Generator().manual_seed(seed)
    state = {k: (0.5 + torch.rand(v.shape, generator=g) if k.endswith("running_var")
                 else 0.2 * torch.randn(v.shape, generator=g)) if v.is_floating_point() else v
             for k, v in old.state_dict().items()}
    new.load_state_dict(state)
    old.load_state_dict(copy.deepcopy(state))
    host = _pyramid(seed)
    shapes = [tuple(s >> i for s in (16, 32, 32)) for i in range(5)]

    def levels(cls):
        t = {k: torch.as_tensor(v.astype(np.int64) if v.dtype != bool else v)
             for k, v in host.items()}
        return [cls(t[f"lvl{i}_coords"], t[f"lvl{i}_valid"], t[f"lvl{i}_nbr"],
                    t.get(f"lvl{i}_down"), shapes[i]) for i in range(5)]

    code = torch.randn(1024, 32, generator=g)
    with torch.no_grad():
        old_levels = levels(frozen_sparse_conv.SparseLevel)
        for a, b in itertools.zip_longest(new.features(code, levels(SparseLevel)),
                                          old.features(code, old_levels)):
            assert torch.equal(a, b)
        for a, b in itertools.zip_longest(
                sparse_net_dense_eval(new, code, levels(SparseLevel)),
                frozen_sparse_net.sparse_net_dense_eval(
                    old, code, levels(frozen_sparse_conv.SparseLevel))):
            assert torch.equal(a, b)
