"""THuman synthetic-render dataset ("CustomDataset"; gpnerf_tpu/data/
thuman.py, the same semantics).

Behavioral port of reference libs/datasets/CustomDataset.py:33-448:
JSON annotation lists (train_anno.json / test_anno.json, truncated to the
first 7 humans, :84-92), 24 synthetic cameras on a circle (vsight_gap),
circular camera-index distance view selection (:196-217), fixed test views
[5, 10, 17, 23] (:183), SMPL given in target-camera coords -> world via the
pose inverse (:247-254), world == SMPL coords (Rh=eye, Th=0, :292-293), no
undistortion (:349), mask boundary band -> 100 (:71-80). THuman rays use
the neg_ray parameterization (build_render: 'thuman' in dataset name).
"""

from __future__ import annotations

import json
import os.path as osp
import random

import numpy as np

from gpnerf_tpu_torch.data.base import HumanNVSDataset, _pad_rays, prepare_smpl_input
from gpnerf_tpu_torch.data.geometry import sample_ray
from gpnerf_tpu_torch.ops.image import dilate, erode, imread, resize


class CustomDataset(HumanNVSDataset):
    def __init__(self, data_root, split, ratio=0.5, fix_human=False,
                 fix_pose=False, **kwargs):
        super().__init__(split=split, **kwargs)
        self.data_root = data_root
        self.ratio = ratio
        self.fix_human = fix_human
        self.fix_pose = fix_pose
        assert osp.exists(data_root), data_root

        anno_path = osp.join(
            data_root, "train_anno.json" if split == "train" else "test_anno.json"
        )
        with open(anno_path) as f:
            annot_list = json.load(f)
        annot_list = annot_list[:7]  # reference truncation (:92)
        if self.fix_human:
            annot_list = [annot_list[random.sample(range(len(annot_list)), 1)[0]]]
        self.anno_list = []
        for annot in annot_list:
            pose_list = annot["multiposes"]
            if self.fix_pose:
                pose_list = [pose_list[random.sample(range(len(pose_list)), 1)[0]]]
            self.anno_list.extend(pose_list)
        self.items = [("thuman", i) for i in range(len(self.anno_list))]
        self.num_cams = 1  # index == pose (target cam drawn inside __getitem__)

    def __len__(self):
        return len(self.anno_list)

    def get_mask(self, msk_path, border=5):
        msk = (imread(msk_path) != 0).astype(np.uint8)
        if msk.ndim == 3:
            msk = msk[..., 0]
        msk_erode = erode(msk, border)
        msk_dilate = dilate(msk, border)
        msk = msk.astype(np.int64)
        msk[(msk_dilate - msk_erode) == 1] = 100
        return msk

    def _load_cam(self, annot, cam_id):
        cam = np.load(
            osp.join(self.data_root, annot[cam_id]["camera_params_path"].lstrip("/")),
            allow_pickle=True,
        ).item()
        return (
            np.array(cam["K"], np.float64),
            np.array(cam["R"], np.float64),
            np.array(cam["T"], np.float64).reshape(3),
        )

    def _load_view(self, annot, cam_id):
        img = imread(
            osp.join(self.data_root, annot[cam_id]["rgb_imgs_path"].lstrip("/"))
        )[..., :3]
        msk = self.get_mask(
            osp.join(self.data_root, annot[cam_id]["masks_path"].lstrip("/"))
        )
        H, W = int(img.shape[0] * self.ratio), int(img.shape[1] * self.ratio)
        img = resize(img, (W, H), "area").astype(np.float32) / 255.0
        msk = resize(msk.astype(np.uint8), (W, H), "nearest").astype(np.int64)
        return img, msk

    def _select_views(self, total_cam_num):
        """Circular camera-index distance selection (:145-217)."""
        if self.split == "train":
            if self.cam_num != -1:
                subsample_factor = np.random.choice(np.arange(1, 3), p=[0.75, 0.25])
                train_base_id = random.sample(range(total_cam_num), 1)[0]
                valid_train_ids = [
                    (train_base_id + i * int(total_cam_num / self.cam_num))
                    % total_cam_num
                    for i in range(self.cam_num)
                ]
                test_ids = [
                    i for i in range(total_cam_num) if i not in valid_train_ids
                ]
                target_id = random.sample(test_ids, 1)[0]
            else:
                subsample_factor = np.random.choice(np.arange(1, 4), p=[0.2, 0.45, 0.35])
                select_test_ids = list(range(total_cam_num))
                target_id = random.sample(select_test_ids, 1)[0]
                test_ids = [target_id]
        else:
            subsample_factor = 1
            test_ids = [5, 10, 17, 23]
            target_id = random.sample(test_ids, 1)[0]
            if self.cam_num != -1:
                valid_train_ids = [
                    (i * int(total_cam_num / self.cam_num)) % total_cam_num
                    for i in range(self.cam_num)
                ]
                test_ids = list(
                    set(
                        [i for i in range(total_cam_num) if i not in valid_train_ids]
                        + test_ids
                    )
                )

        dists0 = np.array(
            [max(c, target_id) - min(c, target_id) for c in range(total_cam_num)]
        )
        dists1 = (
            np.array(
                [min(c, target_id) - max(c, target_id) for c in range(total_cam_num)]
            )
            + 24
        )
        dists = np.stack([dists0, dists1], -1).min(axis=-1)
        num_select = min(
            self.src_view_num * subsample_factor, 8, total_cam_num - len(test_ids)
        )
        dists = dists.astype(np.float64)
        dists[test_ids] = 1e3
        nearest = np.argsort(dists)[:num_select]
        if self.cam_num == -1 or self.cam_num > self.src_view_num:
            nearest = np.random.choice(
                nearest, min(self.src_view_num, len(nearest)), replace=False
            )
            if self.split == "train" and np.random.choice([0, 1], p=[0.995, 0.005]):
                nearest[np.random.choice(len(nearest))] = target_id
        return int(target_id), np.asarray(nearest, np.int64)

    def __getitem__(self, index):
        if isinstance(index, (list, tuple)):
            index = index[0]
        annot_item = self.anno_list[index]
        total_cam_num = int(360 / annot_item["vsight_gap"])
        annot = annot_item["multiviews"]
        target_id, src_ids = self._select_views(total_cam_num)

        K, R, T = self._load_cam(annot, target_id)
        img, msk = self._load_view(annot, target_id)
        if self.mask_bkgd:
            img = img.copy()
            img[msk == 0] = 0
        K = K.copy()
        K[:2] *= self.ratio
        tar_img = np.round(img * 255.0).astype(np.uint8)

        # SMPL: camera coords -> world (:247-254); world == SMPL coords
        xyz = np.load(
            osp.join(self.data_root, annot[target_id]["smpl_vertices_path"].lstrip("/"))
        ).astype(np.float32)
        pose = np.eye(4)
        pose[:3, :3] = R
        pose[:3, 3] = T
        pose_inv = np.linalg.inv(pose)
        xyz_h = np.hstack([xyz, np.ones_like(xyz[:, :1])])
        xyz = (xyz_h @ pose_inv.T)[:, :3].astype(np.float32)

        Rh = np.eye(3, dtype=np.float32)
        Th = np.zeros((1, 3), np.float32)
        (
            feature, coord, out_sh, can_bounds, bounds, _xyz_can, _aug
        ) = prepare_smpl_input(xyz, Rh, Th, self.voxel_size, self.max_out_sh)

        rgb, ray_o, ray_d, near, far, _coord2d, mask_at_box, body_msk = sample_ray(
            img, msk, K, R, T, can_bounds, self.nrays, self.split,
            self.body_sample_ratio,
        )
        ray_cap = self.nrays if self.split == "train" else self.test_ray_cap
        padded, n_rays = _pad_rays(
            {
                "rgb": rgb,
                "ray_o": ray_o,
                "ray_d": ray_d,
                "near": near.astype(np.float32),
                "far": far.astype(np.float32),
                "body_msk": body_msk.astype(np.float32),
            },
            len(rgb),
            ray_cap,
        )
        if self.split == "train":
            mask_at_box = padded["ray_valid"] > 0

        src_imgs, src_poses, src_Ks = [], [], []
        for cam_ind in src_ids:
            sK, sR, sT = self._load_cam(annot, int(cam_ind))
            simg, smsk = self._load_view(annot, int(cam_ind))
            if self.mask_bkgd:
                simg = simg.copy()
                simg[smsk == 0] = 0
            sK = sK.copy()
            sK[:2] *= self.ratio
            src_imgs.append(np.round(simg * 255.0).astype(np.uint8))
            src_poses.append(
                np.concatenate([sR, sT.reshape(3, 1)], axis=-1).astype(np.float32)
            )
            src_Ks.append(sK.astype(np.float32))

        target_pose = np.concatenate([R, T.reshape(3, 1)], axis=-1).astype(np.float32)
        H, W = img.shape[:2]
        ret = {
            "tar_img": tar_img,
            "feature": feature,
            "coord": coord,
            "out_sh": out_sh,
            "mask_at_box": mask_at_box,
            "target_pose": target_pose,
            "target_K": K.astype(np.float32),
            "target_K_inv": np.linalg.inv(K).astype(np.float32),
            "src_imgs": np.stack(src_imgs),
            "src_poses": np.stack(src_poses),
            "src_Ks": np.stack(src_Ks),
            "can_bounds": can_bounds,
            "bounds": bounds,
            "R": Rh,
            "Rh": Rh,
            "Th": Th,
            "latent_index": np.int32(index),
            "frame_index": np.int32(index),
            "cam_ind": np.int32(target_id),
            "n_rays": np.int32(n_rays),
            "img_hw": np.asarray([H, W], np.int32),
        }
        ret.update(padded)
        from gpnerf_tpu_torch.data.sparse_host import build_host_pyramid

        ret.update(
            build_host_pyramid(
                coord, self.max_out_sh, self.site_cap, self.level_caps
            )
        )
        if self.with_mesh_grid:
            pts = self.mesh_grid(can_bounds)
            ret["pts"] = pts
            ret["inside"] = self._inside_pts(pts, annot)
        return ret

    def _inside_pts(self, pts, annot):
        """Visual hull from full-res masks (CustomDataset.prepare_inside_pts,
        :108-132)."""
        from gpnerf_tpu_torch.data.geometry import project

        sh = pts.shape
        pts3d = pts.reshape(-1, 3)
        inside = np.ones(len(pts3d), np.uint8)
        for nv in self.inside_view:
            ind = inside == 1
            K, R, T = self._load_cam(annot, nv)
            msk = (
                self.get_mask(
                    osp.join(self.data_root, annot[nv]["masks_path"].lstrip("/"))
                )
                != 0
            ).astype(np.uint8)
            RT = np.concatenate([R, T.reshape(3, 1)], axis=1)
            pts2d = np.round(project(pts3d[ind], K, RT)).astype(np.int32)
            H, W = msk.shape[:2]
            pts2d[:, 0] = np.clip(pts2d[:, 0], 0, W - 1)
            pts2d[:, 1] = np.clip(pts2d[:, 1], 0, H - 1)
            inside[ind] = msk[pts2d[:, 1], pts2d[:, 0]]
        return inside.reshape(*sh[:-1])


def build_dataset(cfg, is_train=True):
    """Factory mirroring CustomDataset.build_dataset (:408-440)."""
    split_cfg = cfg.dataset.train if is_train else cfg.dataset.test
    return CustomDataset(
        data_root=split_cfg.data_root,
        split="train" if is_train else "test",
        ratio=cfg.dataset.ratio,
        fix_human=cfg.fix_human,
        fix_pose=cfg.fix_pose,
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
        neg_ray=True,
        with_mesh_grid=not cfg.head.rgb.use_rgbhead,
    )


from gpnerf_tpu_torch.registry import register  # noqa: E402

register("dataset", "CustomDataset", build_dataset)
