"""SyntheticDataset: HumanNVSDataset over the procedural scene.

The fixture analog of ZjumocapDataset — same batch contract, no disk IO.
Camera split follows the reference's cam_num==3 convention
(reference libs/datasets/ZjumocapDataset.py:198-204): train cams
[0, 8, 16], test cams every `interval`-th.
"""

from __future__ import annotations

import numpy as np

from gpnerf_tpu_torch.data.base import HumanNVSDataset
from gpnerf_tpu_torch.data.synthetic import SyntheticScene


class SyntheticDataset(HumanNVSDataset):
    def __init__(
        self,
        split: str,
        n_frames=30,
        n_cams=12,
        img_hw=(512, 512),
        interval=6,
        seed=0,
        **kwargs,
    ):
        super().__init__(split=split, **kwargs)
        self.scene = SyntheticScene(n_cams=n_cams, img_hw=img_hw, seed=seed)
        self.items = [("synthetic", f) for f in range(n_frames)]
        test_ids = np.arange(n_cams)[::interval]
        if self.cam_num == 3:
            train_ids = np.array([0, n_cams // 3, 2 * n_cams // 3], np.int64)
        else:
            train_ids = np.array(
                [j for j in range(n_cams) if j not in test_ids], np.int64
            )
        Ks, Rs, Ts = self.scene.Ks, self.scene.Rs, self.scene.Ts
        if self.neg_ray:
            # serve OpenGL-convention cameras (scene at NEGATIVE camera z —
            # the convention that makes THuman neg_ray; CustomDataset
            # renders, data_utils.py:123-127 sign handling). Converted
            # pixel-identically from the OpenCV rig via F = diag(1, 1, -1):
            # R' = F R, T' = F T, fx' = -fx, fy' = -fy — the splat renders
            # stay valid ground truth for the converted cameras.
            F = np.diag([1.0, 1.0, -1.0]).astype(np.float32)
            # pixel identity under F additionally needs zero skew: with
            # K[0,1] != 0 the u row would require negating the skew term
            # too (u_h' must equal -u_h). Guard so a future skewed fixture
            # fails loudly instead of silently breaking the ground truth.
            assert np.allclose(Ks[:, 0, 1], 0.0), "neg_ray conversion assumes zero skew"
            Ks = Ks.copy()
            Ks[:, 0, 0] *= -1.0
            Ks[:, 1, 1] *= -1.0
            Rs = np.einsum("ij,njk->nik", F, Rs).astype(np.float32)
            Ts = np.einsum("ij,njk->nik", F, Ts.reshape(-1, 3, 1)).astype(
                np.float32
            )
        self._cams = {
            "K": Ks,
            "R": Rs,
            "T": Ts,
            "train_ids": train_ids,
            "test_ids": test_ids,
        }
        self.num_cams = len(train_ids) if split == "train" else len(test_ids)

    def cameras(self, seq):
        return self._cams

    def load_view(self, seq, frame_id, cam_id):
        return self.scene.render_view(frame_id, cam_id)

    def load_smpl(self, seq, frame_id):
        world, _colors, Rh, Th, _can = self.scene.vertices_world(frame_id)
        return world, Rh, Th

    def mask_and_camera(self, seq, frame_id, cam_id):
        cam_id = cam_id % self.scene.n_cams
        _img, msk = self.scene.render_view(frame_id, cam_id)
        c = self._cams
        return msk, c["K"][cam_id], c["R"][cam_id], c["T"][cam_id]


def build_dataset(cfg, is_train=True):
    split_cfg = cfg.dataset.train if is_train else cfg.dataset.test
    H = int(cfg.dataset.H * cfg.dataset.ratio)
    W = int(cfg.dataset.W * cfg.dataset.ratio)
    return SyntheticDataset(
        split="train" if is_train else "test",
        n_cams=split_cfg.dataset_cams,
        img_hw=(H, W),
        interval=split_cfg.interval,
        src_view_num=cfg.src_view_num,
        cam_num=cfg.cam_num,
        nrays=cfg.train.n_rays,
        body_sample_ratio=cfg.train.body_sample_ratio,
        mask_bkgd=cfg.mask_bkgd,
        voxel_size=tuple(cfg.dataset.voxel_size),
        max_out_sh=tuple(cfg.tpu.max_out_sh),
        site_cap=cfg.tpu.site_cap,
        level_caps=tuple(cfg.tpu.level_caps),
        test_ray_cap=cfg.tpu.eval_ray_cap,
        frame_sampler=(cfg.dataset.test.sampler == "FrameSampler"),
        neg_ray="thuman" in split_cfg.name,
        with_mesh_grid=not cfg.head.rgb.use_rgbhead,
    )


from gpnerf_tpu_torch.registry import register  # noqa: E402

register("dataset", "SyntheticDataset", build_dataset)
