"""The inputs of a run, drawn from its seed: the request pool of the view
traffic and the batches of the train traffic, each a host batch that a
data layer assembles from the frozen scene (benchmark/scene.py).

Both sides assemble their own batches from the same raw inputs (poses,
cameras, the splatted images): the program through its data layer
(`gpnerf_tpu_torch.data.base.HumanNVSDataset`), the reference through its
frozen copy (benchmark/reference/eager/data/base.py). `PoolItems` serves
either class the scene's items; `build_batches` seeds Python's and numpy's
global generators per item, since both data layers draw from them.
"""

from __future__ import annotations

import random

import numpy as np

from benchmark.scene import Scene, make_cameras, ring_camera

RING_CAMS = 12
# the reference's cam_num 3 rig on the 12-camera ring (ZjumocapDataset.py:198-204)
SOURCE_IDS = (0, 4, 8)
# the pose indices the checkpoint was trained on span [0, 30)
N_POSES = 30
# the seed streams of the per-item generators (`build_batches`)
VIEW_TAG, TRAIN_TAG = 10, 20


def seed_words(seed, *tags):
    """A numpy SeedSequence entropy list for any whole `seed` and tags."""
    return [int(seed) & (2**64 - 1)] + [int(t) for t in tags]


def rng_for(seed, *tags):
    return np.random.default_rng(np.random.SeedSequence(seed_words(seed, *tags)))


class PoolItems:
    """A mixin over a HumanNVSDataset class: item i is (i, pose index) with
    the cameras of `cams[i]` (K, R, T, train_ids, test_ids); images and the
    body come from the shared `scene`."""

    def __init__(self, scene, poses, cams, *, split, **kwargs):
        super().__init__(split=split, **kwargs)
        self.scene = scene
        self.items = [(i, float(p)) for i, p in enumerate(poses)]
        self._cams = cams
        self.num_cams = 1

    def cameras(self, seq):
        return self._cams[seq]

    def load_view(self, seq, frame_id, cam_id):
        c = self._cams[seq]
        return self.scene.render(frame_id, c["K"][cam_id], c["R"][cam_id], c["T"][cam_id])

    def load_smpl(self, seq, frame_id):
        world, _, Rh, Th = self.scene.vertices_world(frame_id)
        return world, Rh, Th


def dataset_kwargs(cfg):
    """The data layer's arguments from a configuration's `cfg` tree."""
    t, tpu = cfg["train"], cfg["tpu"]
    return dict(
        src_view_num=cfg["src_view_num"], cam_num=cfg["cam_num"], nrays=t["n_rays"],
        body_sample_ratio=t["body_sample_ratio"], mask_bkgd=cfg["mask_bkgd"],
        voxel_size=tuple(cfg["dataset"]["voxel_size"]), max_out_sh=tuple(tpu["max_out_sh"]),
        site_cap=tpu["site_cap"], level_caps=tuple(tpu["level_caps"]),
        test_ray_cap=tpu["eval_ray_cap"], frame_sampler=True, neg_ray=False,
    )


def img_hw(cfg):
    d = cfg["dataset"]
    return int(d["H"] * d["ratio"]), int(d["W"] * d["ratio"])


def view_items(seed, n, hw):
    """`n` novel-view requests: item i is a target camera at a seeded angle
    in the i-th of n arcs of the ring, the performer at a seeded pose in a
    seeded one of n equal stretches of [0, N_POSES), seen by the three
    source cameras. Every seed draws one item from each arc and each
    stretch, so the seeds differ in content and little in work."""
    rng = rng_for(seed, 1)
    stretch, u, v = rng.permutation(n), rng.random(n), rng.random(n)
    Ks, Rs, Ts = make_cameras(RING_CAMS, hw)
    poses, cams = [], []
    for i in range(n):
        poses.append(N_POSES * (stretch[i] + u[i]) / n)
        K, R, T = ring_camera(2 * np.pi * (i + v[i]) / n, hw)
        cams.append({"K": np.concatenate([Ks, K[None]]), "R": np.concatenate([Rs, R[None]]),
                     "T": np.concatenate([Ts, T[None]]),
                     "train_ids": np.asarray(SOURCE_IDS, np.int64),
                     "test_ids": np.asarray([RING_CAMS], np.int64)})
    return poses, cams


def request_order(seed, n):
    """The seeded order in which the requests cycle through the pool."""
    return rng_for(seed, 2).permutation(n)


def train_items(seed, n, hw):
    """`n` train frames: the performer at a seeded pose in a seeded one of
    n equal stretches of [0, N_POSES), on the 12-camera ring with the
    three source cameras; the target camera and the rays are the data
    layer's draws."""
    rng = rng_for(seed, 3)
    stretch, u = rng.permutation(n), rng.random(n)
    Ks, Rs, Ts = make_cameras(RING_CAMS, hw)
    cam = {"K": Ks, "R": Rs, "T": Ts, "train_ids": np.asarray(SOURCE_IDS, np.int64),
           "test_ids": np.asarray([0, RING_CAMS // 2], np.int64)}
    return [N_POSES * (stretch[i] + u[i]) / n for i in range(n)], [cam] * n


def make_dataset(base_cls, scene, poses, cams, split, cfg):
    cls = type(f"Pool{base_cls.__name__}", (PoolItems, base_cls), {})
    return cls(scene, poses, cams, split=split, **dataset_kwargs(cfg))


def build_batches(ds, seed, indices, tag):
    """Host batches of items `indices`, Python's and numpy's global
    generators seeded per item from (seed, tag, item)."""
    out = []
    for i in indices:
        s = np.random.SeedSequence(seed_words(seed, tag, i)).generate_state(1)[0]
        random.seed(int(s))
        np.random.seed(int(s))
        out.append(ds[int(i)])
    return out


def new_scene(cfg):
    return Scene(img_hw(cfg))
