"""ZJU-MoCap dataset (gpnerf_tpu/data/zjumocap.py, the same semantics).

Behavioral port of reference libs/datasets/ZjumocapDataset.py:18-563
over the shared HumanNVSDataset assembly: annots.npy camera tables
(K/R/T/D + per-frame image lists), per-sequence frame windows
(data_config, :88-159), the cam_num==3 camera split (train cams [0, 8, 16],
test cams every `interval`-th, :198-204), mask | mask_cihp with the
eroded/dilated boundary band labeled 100 (:68-86), undistortion, the
1024 -> ratio resize chain (:356-379), SMPL vertices/params loading with
Rodrigues (:207-256), and the CoreView_313/315 filename quirk (:390-396).
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from gpnerf_tpu_torch.data.base import HumanNVSDataset
from gpnerf_tpu_torch.ops.image import dilate, erode, imread, resize, rodrigues, undistort

# per-sequence frame windows (ZjumocapDataset.data_config :88-159)
SEQ_CONFIG = {
    "CoreView_313": {"begin_i": 1, "intv": 1, "ni": 300},
    "CoreView_315": {"begin_i": 1, "intv": 1, "ni": 300},
    "CoreView_377": {"begin_i": 0, "intv": 1, "ni": 300},
    "CoreView_386": {"begin_i": 0, "intv": 1, "ni": 300},
    "CoreView_387": {"begin_i": 0, "intv": 1, "ni": 300},
    "CoreView_390": {"begin_i": 700, "intv": 1, "ni": 300},
    "CoreView_392": {"begin_i": 0, "intv": 1, "ni": 300},
    "CoreView_393": {"begin_i": 0, "intv": 1, "ni": 300},
    "CoreView_394": {"begin_i": 0, "intv": 1, "ni": 300},
    "CoreView_396": {"begin_i": 810, "intv": 1, "ni": 300},
}


class ZjumocapDataset(HumanNVSDataset):
    def __init__(self, data_root, split, seq_data=("CoreView_315",), ratio=0.5,
                 interval=7, dataset_cams=24, inside_view=(0, 6, 12, 18), **kwargs):
        super().__init__(split=split, **kwargs)
        self.data_root = data_root
        self.ratio = ratio
        self.interval = interval
        self.inside_view = inside_view
        assert osp.exists(data_root), data_root

        self.items = []
        self._annots = {}
        self._cam_tables = {}
        self._frame_ims = {}
        for seq in seq_data:
            seq_path = osp.join(data_root, seq)
            annots = np.load(
                osp.join(seq_path, "annots.npy"), allow_pickle=True
            ).item()
            cams = annots["cams"]
            sc = SEQ_CONFIG[seq]
            ims = [
                np.array(ims_data["ims"])
                for ims_data in annots["ims"][
                    sc["begin_i"] : sc["begin_i"] + sc["ni"] * sc["intv"] : sc["intv"]
                ]
            ]
            self._annots[seq] = annots
            self._frame_ims[seq] = ims
            num_cams_total = len(ims[0])
            test_ids = np.arange(num_cams_total)[:: self.interval]
            if self.cam_num == 3:
                train_ids = np.array([0, 8, 16], np.int64)
            else:
                train_ids = np.array(
                    [j for j in np.arange(num_cams_total) if j not in test_ids],
                    np.int64,
                )
            K_full = np.array(cams["K"], np.float64)
            K_scaled = K_full.copy()
            K_scaled[:, :2] *= self.ratio  # images are ratio-scaled (:379)
            self._cam_tables[seq] = {
                "K": K_scaled,
                "K_full": K_full,
                "D": np.array(cams["D"], np.float64),
                "R": np.array(cams["R"], np.float64),
                "T": np.array(cams["T"], np.float64) / 1000.0,
                "train_ids": train_ids,
                "test_ids": test_ids,
            }
            for fi in range(len(ims)):
                self.items.append((seq, fi))
        first = seq_data[0]
        self.num_cams = (
            len(self._cam_tables[first]["train_ids"])
            if split == "train"
            else len(self._cam_tables[first]["test_ids"])
        )

    # -- subclass API --------------------------------------------------
    def cameras(self, seq):
        t = self._cam_tables[seq]
        # base.select_views uses unscaled R/T only (camera centers)
        return t

    def get_mask(self, seq, img_name, border=5):
        """mask | mask_cihp, boundary band -> 100 (ZjumocapDataset:68-86)."""
        seq_path = osp.join(self.data_root, seq)
        msk = None
        p = osp.join(seq_path, "mask", img_name)[:-4] + ".png"
        if os.path.exists(p):
            msk = (imread(p) != 0).astype(np.uint8)
            if msk.ndim == 3:
                msk = msk[..., 0]
        p = osp.join(seq_path, "mask_cihp", img_name)[:-4] + ".png"
        msk_cihp = (imread(p) != 0).astype(np.uint8)
        if msk_cihp.ndim == 3:
            msk_cihp = msk_cihp[..., 0]
        msk = (msk | msk_cihp) if msk is not None else msk_cihp
        msk_erode = erode(msk, border)
        msk_dilate = dilate(msk, border)
        msk = msk.astype(np.int64)
        msk[(msk_dilate - msk_erode) == 1] = 100
        return msk

    def _frame_to_index(self, seq, frame_id):
        """frame_id here is the item's frame slot; resolve the image name
        and the SMPL index (313/315 use 1-based underscore names)."""
        return self._frame_ims[seq][frame_id]

    def load_view(self, seq, frame_id, cam_id):
        seq_path = osp.join(self.data_root, seq)
        img_name = str(self._frame_ims[seq][frame_id][cam_id])
        img = imread(osp.join(seq_path, img_name))[..., :3]
        img = resize(img, (1024, 1024), "area")
        msk = self.get_mask(seq, img_name)
        t = self._cam_tables[seq]
        K = t["K_full"][cam_id]  # undistortion happens at full resolution
        D = t["D"][cam_id]
        img = undistort(img, K, D)
        msk = undistort(msk.astype(np.uint8), K, D).astype(np.int64)
        H, W = int(img.shape[0] * self.ratio), int(img.shape[1] * self.ratio)
        img = resize(img, (W, H), "area").astype(np.float32) / 255.0
        msk = resize(msk.astype(np.uint8), (W, H), "nearest").astype(np.int64)
        return img, msk

    def scaled_K(self, seq, cam_id):
        K = self._cam_tables[seq]["K"][cam_id].copy()
        K[:2] *= self.ratio
        return K.astype(np.float32)

    def smpl_index(self, seq, frame_id):
        img_name = str(self._frame_ims[seq][frame_id][0])
        if seq in ("CoreView_313", "CoreView_315"):
            i = int(osp.basename(img_name).split("_")[4])
        else:
            i = int(osp.basename(img_name)[:-4])
        return i

    def mask_and_camera(self, seq, frame_id, cam_id):
        """Visual-hull views use full-resolution masks + unscaled K
        (ZjumocapDataset.prepare_inside_pts, :259-283)."""
        img_name = str(self._frame_ims[seq][frame_id][cam_id])
        msk = (self.get_mask(seq, img_name) != 0).astype(np.uint8)
        t = self._cam_tables[seq]
        return msk, t["K_full"][cam_id], t["R"][cam_id], t["T"][cam_id]

    def load_smpl(self, seq, frame_id):
        seq_path = osp.join(self.data_root, seq)
        i = self.smpl_index(seq, frame_id)
        xyz = np.load(osp.join(seq_path, "vertices", f"{i}.npy")).astype(np.float32)
        params = np.load(
            osp.join(seq_path, "params", f"{i}.npy"), allow_pickle=True
        ).item()
        Rh = params["Rh"]
        R = rodrigues(Rh).astype(np.float32)
        Th = params["Th"].astype(np.float32).reshape(1, 3)
        return xyz, R, Th

    def __getitem__(self, index):
        if isinstance(index, (list, tuple)):
            index = index[0]
        item = index // self.num_cams
        seq, frame_slot = self.items[item]
        ret = super().__getitem__(index)
        # reference frame bookkeeping: latent/frame index from the image name
        # (ZjumocapDataset.py:390-396,489)
        i = self.smpl_index(seq, frame_slot)
        frame_index = i - 1 if seq in ("CoreView_313", "CoreView_315") else i
        ret["frame_index"] = np.int32(frame_index)
        ret["latent_index"] = np.int32(frame_index - SEQ_CONFIG[seq]["begin_i"])
        return ret


def build_dataset(cfg, is_train=True):
    """Factory mirroring ZjumocapDataset.build_dataset (:524-563)."""
    split_cfg = cfg.dataset.train if is_train else cfg.dataset.test
    return ZjumocapDataset(
        data_root=split_cfg.data_root,
        split="train" if is_train else "test",
        seq_data=tuple(split_cfg.seq_list),
        ratio=cfg.dataset.ratio,
        interval=split_cfg.interval,
        dataset_cams=split_cfg.dataset_cams,
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

register("dataset", "ZjumocapDataset", build_dataset)
