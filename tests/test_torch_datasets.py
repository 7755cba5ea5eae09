"""The port's datasets against their JAX twins, batch for batch and bit
for bit: `ZjumocapDataset` (gpnerf_tpu_torch/data/zjumocap.py) and
`CustomDataset` (data/thuman.py, THuman, neg-ray) on the fabricated
on-disk trees of tests/test_dataset_fixtures.py, both splits, several
indices, with stdlib `random` and `np.random` seeded alike before each
item; the visual-hull grid of the mesh branch (`head.rgb.use_rgbhead
False`); the bench frames of the `thuman-synthetic` fixture
(utils/bench_frames.py); and the OpenGL-convention cameras of the port's
`SyntheticDataset` (the twin of tests/test_dataset_fixtures.py::
test_synthetic_neg_ray_camera_conversion)."""

import os
import random

import numpy as np
import pytest
from test_dataset_fixtures import thuman_root  # noqa: F401  (a fixture)

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.utils.bench_frames import get_bench_frames as jax_bench_frames
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _zju_cfg(base, root, **extra):
    """configs/trainzju_valzju.yaml on the fabricated tree at 1024 -> 128."""
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "trainzju_valzju.yaml"))
    for split in ("train", "test"):
        cfg.dataset[split].data_root = root
        cfg.dataset[split].seq_list = ["CoreView_387"]
    cfg.dataset.ratio = 0.125
    cfg.train.n_rays = 64
    cfg.tpu.eval_ray_cap = 16384
    cfg.merge_from_list([x for kv in extra.items() for x in kv])
    cfg.freeze()
    return cfg


def _thu_cfg(base, root, **extra):
    """configs/trainthu_valzju.yaml with THuman on both splits, 256 -> 128."""
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "trainthu_valzju.yaml"))
    for split in ("train", "test"):
        blk = cfg.dataset[split]
        blk.data_root = root
        blk.name = "thuman"
        blk.file = "CustomDataset"
    cfg.dataset.ratio = 0.5
    cfg.train.n_rays = 64
    cfg.tpu.eval_ray_cap = 16384
    cfg.merge_from_list([x for kv in extra.items() for x in kv])
    cfg.freeze()
    return cfg


def _assert_same_batch(pb, jb, what):
    assert set(pb) == set(jb), (what, set(pb) ^ set(jb))
    for k, jv in jb.items():
        pv, jv = np.asarray(pb[k]), np.asarray(jv)
        assert pv.dtype == jv.dtype and pv.shape == jv.shape, (what, k, pv.dtype, jv.dtype,
                                                               pv.shape, jv.shape)
        np.testing.assert_array_equal(pv, jv, err_msg=f"{what}: {k}")


def _item(ds, index, seed):
    random.seed(seed)
    np.random.seed(seed)
    return ds[index]


def _compare(make_cfg, root, dataset, cases, **extra):
    """Build both packages' datasets of `dataset` on `root` and compare the
    items (split, index, seed) of `cases`. Returns the port's batches."""
    out = []
    for is_train in (True, False):
        jc, pc = make_cfg(jax_cfg, root, **extra), make_cfg(port_cfg, root, **extra)
        np.random.seed(0)
        random.seed(0)
        jds = jax_get("dataset", dataset)(jc, is_train=is_train)
        np.random.seed(0)
        random.seed(0)
        pds = port_get("dataset", dataset)(pc, is_train=is_train)
        assert len(pds) == len(jds) and pds.neg_ray == jds.neg_ray
        split = "train" if is_train else "test"
        for index, seed in cases[split]:
            pb = _item(pds, index, seed)
            _assert_same_batch(pb, _item(jds, index, seed), f"{dataset} {split}[{index}]")
            out.append((split, pb))
    return out


def test_zjumocap_matches_jax(zju_root):
    """Two frames x three train cams and four test cams on disk: the mm
    translations, the distortion, the mask | mask_cihp border band and the
    cam_num = 3 split reach both packages' batches alike."""
    out = _compare(_zju_cfg, zju_root, "ZjumocapDataset",
                   {"train": [(0, 0), (4, 3)], "test": [(1, 1), (6, 2)]})
    for split, b in out:
        assert not (b["near"][: int(b["n_rays"])] < 0).any()
        assert b["src_imgs"].shape == (3, 128, 128, 3)
        if split == "train":
            assert int(b["n_rays"]) == 64
            assert int(b["cam_ind"]) not in (0, 8, 16)  # targets off the train cams
        else:
            assert int(b["n_rays"]) > 200
    assert {int(b["frame_index"]) for _, b in out} == {0, 1}


def test_thuman_matches_jax(thuman_root):  # noqa: F811
    """One human x one pose x 24 cameras: circular view selection, the
    fixed test views, camera-coordinate SMPL and neg-ray t-spans."""
    out = _compare(_thu_cfg, thuman_root, "CustomDataset",
                   {"train": [(0, 0), (0, 5)], "test": [(0, 0), (0, 1), (0, 4)]})
    for split, b in out:
        n = int(b["n_rays"])
        assert (b["near"][:n] < 0).all() and (b["far"][:n] < 0).all()
        if split == "test":
            assert int(b["cam_ind"]) in (5, 10, 17, 23)
    assert len({int(b["cam_ind"]) for s, b in out if s == "test"}) > 1


@pytest.mark.parametrize("dataset", ["ZjumocapDataset", "CustomDataset"])
def test_mesh_grid_and_inside_match_jax(zju_root, thuman_root, dataset):  # noqa: F811
    """With the mesh branch on, each item carries the dense grid over its
    canonical bounds and the visual hull of the inside views' masks."""
    make, root = ((_zju_cfg, zju_root) if dataset == "ZjumocapDataset"
                  else (_thu_cfg, thuman_root))
    jc = make(jax_cfg, root, **{"head.rgb.use_rgbhead": False})
    pc = make(port_cfg, root, **{"head.rgb.use_rgbhead": False})
    jds = jax_get("dataset", dataset)(jc, is_train=False)
    pds = port_get("dataset", dataset)(pc, is_train=False)
    pb = _item(pds, 0, 3)
    _assert_same_batch(pb, _item(jds, 0, 3), f"{dataset} test[0] with the mesh grid")
    assert pb["pts"].shape[:-1] == pb["inside"].shape and 0 < pb["inside"].mean() < 1


def test_thuman_synthetic_bench_frames_match_jax(tmp_path):
    """The bench protocol on the neg fixture (bench.py's neg mode)."""
    def cfg(base):
        c = base.clone()
        c.defrost()
        c.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
        c.dataset.H = c.dataset.W = 128
        c.dataset.test.name = "thuman-synthetic"
        c.freeze()
        return c

    ours = get_bench_frames(cfg(port_cfg), 2)
    theirs = jax_bench_frames(cfg(jax_cfg), 2, cache_root=str(tmp_path), verbose=False)
    assert len(ours) == len(theirs) == 2
    for i, (pb, jb) in enumerate(zip(ours, theirs)):
        _assert_same_batch(pb, jb, f"bench frame {i}")
        n = int(pb["n_rays"])
        assert (pb["near"][:n] < 0).all()


def test_synthetic_neg_ray_camera_conversion():
    """The port's SyntheticDataset under a dataset name holding 'thuman'
    serves OpenGL-convention cameras that are pixel-identical to the OpenCV
    rig: the same images, masks and SMPL prep, the ray segments traced
    with negated t-spans (data_utils.py:123-127)."""
    def build(name):
        cfg = port_cfg.clone()
        cfg.defrost()
        cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
        cfg.dataset.H = 128
        cfg.dataset.W = 128
        cfg.dataset.test.name = name
        cfg.dataset.ratio = 1.0
        cfg.freeze()
        return port_get("dataset", "SyntheticDataset")(cfg, is_train=False)

    pos, neg = build("synthetic"), build("thuman-synthetic")
    assert not pos.neg_ray and neg.neg_ray
    for idx in (0, 3):
        bp, bn = _item(pos, idx, idx), _item(neg, idx, idx)
        for k in ("tar_img", "mask_at_box", "src_imgs", "coord"):
            np.testing.assert_array_equal(bp[k], bn[k], err_msg=k)
        np.testing.assert_allclose(bp["can_bounds"], bn["can_bounds"], atol=1e-6)
        n = int(bp["n_rays"])
        assert n == int(bn["n_rays"])
        for t in ("near", "far"):
            assert (bn[t][:n] < 0).all(), t
        # the segment endpoints coincide with roles swapped: the neg ray's
        # near (most negative t) is the positive ray's far point
        def point(b, t):
            return b["ray_o"][:n] + b[t][:n, None] * b["ray_d"][:n]
        np.testing.assert_allclose(point(bn, "near"), point(bp, "far"), atol=1e-3)
        np.testing.assert_allclose(point(bn, "far"), point(bp, "near"), atol=1e-3)
