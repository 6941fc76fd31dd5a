"""KITTI odometry and KITTI tracking loaders (LiDAR + left colour camera).

A copy of ``pings_tpu/data/kitti.py``: ``KittiDataset`` (:48-185) reads
``velodyne/*.bin`` scans, ``image_2/*.png``, ``calib.txt`` (P2 and Tr),
``poses.txt`` (camera-0 poses, turned into LiDAR-frame poses) and
SemanticKITTI ``labels/*.label`` (reduced by ``SEM_KITTI_LEARNING_MAP``),
with the optional vertical-angle correction of raw scans and per-point
times from the azimuth; ``KittiMotDataset`` (:187-254) the KITTI tracking
layout. Images are read by ``data/imageio.imread_rgb`` (the same array as
``cv2.imread`` followed by ``cv2.COLOR_BGR2RGB``).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from pings_tpu_torch.data.base import BaseDataset, register_loader
from pings_tpu_torch.data.imageio import imread_rgb


def _sem_kitti_learning_map() -> np.ndarray:
    """SemanticKITTI raw-id -> 20-class training-id lookup (the standard
    semantic-kitti-api learning_map; reference reduces labels the same way
    before mapping — slam_dataset.py:1670-1690 'sem_labels_reduced is the
    reduced labels for mapping (20 classes for semantic kitti)').

    Returns a (260,) i32 array: -1 = unlabeled/outlier/other (ignored by
    sem_nll_loss), 1..19 = training classes; moving classes (252-259) map
    to their static counterparts."""
    m = np.full(260, -1, np.int32)
    pairs = {
        10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5,   # vehicles
        30: 6, 31: 7, 32: 8,                                # humans
        40: 9, 44: 10, 48: 11, 49: 12,                      # ground
        50: 13, 51: 14, 60: 9,                              # structure
        70: 15, 71: 16, 72: 17, 80: 18, 81: 19,             # nature/objects
        252: 1, 253: 7, 254: 6, 255: 8,                     # moving -> static
        256: 5, 257: 5, 258: 4, 259: 5,
    }
    for raw, cls in pairs.items():
        m[raw] = cls
    return m


SEM_KITTI_LEARNING_MAP = _sem_kitti_learning_map()


@register_loader("kitti")
class KittiDataset(BaseDataset):
    CAM = "cam2"

    def __init__(self, data_path: str, sequence: str = "00", cfg=None):
        super().__init__(data_path, sequence, cfg)
        seq_dir = os.path.join(data_path, "sequences", sequence) \
            if os.path.isdir(os.path.join(data_path, "sequences")) \
            else os.path.join(data_path, sequence)
        if not os.path.isdir(seq_dir):
            seq_dir = data_path
        self.seq_dir = seq_dir
        self.scan_files = sorted(
            glob.glob(os.path.join(seq_dir, "velodyne", "*.bin")))
        self.img_files = sorted(
            glob.glob(os.path.join(seq_dir, "image_2", "*.png")))
        # SemanticKITTI point labels (reference kitti.py:51-58 detects
        # labels/*.label; emitted here as the frame's "sem" channel)
        self.sem_files = sorted(
            glob.glob(os.path.join(seq_dir, "labels", "*.label")))
        if len(self.sem_files) != len(self.scan_files):
            self.sem_files = []
        self.correction_deg = getattr(cfg, "correction_deg", 0.195) \
            if cfg is not None else 0.195
        self.apply_correction = getattr(cfg, "kitti_correction_on", True) \
            if cfg is not None else True
        self.filter_moving = getattr(cfg, "filter_moving_object", True) \
            if cfg is not None else True

        self.K = None
        self.T_c_l = None
        calib = os.path.join(seq_dir, "calib.txt")
        if os.path.exists(calib):
            self._load_calib(calib)

        self._gt: Optional[List[np.ndarray]] = None
        for cand in (os.path.join(seq_dir, "poses.txt"),
                     os.path.join(data_path, "poses", f"{sequence}.txt")):
            if os.path.exists(cand):
                self._gt = self._load_poses(cand)
                break

    def _load_calib(self, path: str):
        vals = {}
        with open(path) as f:
            for line in f:
                if ":" not in line:
                    continue
                k, v = line.split(":", 1)
                vals[k.strip()] = np.array([float(x) for x in v.split()])
        if "P2" in vals:
            P2 = vals["P2"].reshape(3, 4)
            self.K = P2[:, :3].copy()
            # P2 includes a baseline offset: t = K^-1 * P2[:,3]
            self._t2 = np.linalg.inv(self.K) @ P2[:, 3]
        if "Tr" in vals:
            Tr = np.eye(4)
            Tr[:3, :4] = vals["Tr"].reshape(3, 4)
            self.Tr = Tr  # cam0 <- lidar
            T = Tr.copy()
            if self.K is not None:
                T[:3, 3] += self._t2
            self.T_c_l = T

    def _load_poses(self, path: str) -> List[np.ndarray]:
        """cam0-frame poses -> lidar-frame (reference kitti.py pose
        conversion T_l = Tr^-1 T_cam Tr)."""
        poses = []
        raw = np.loadtxt(path).reshape(-1, 12)
        Tr = getattr(self, "Tr", np.eye(4))
        Tr_inv = np.linalg.inv(Tr)
        for row in raw:
            Tc = np.eye(4)
            Tc[:3, :4] = row.reshape(3, 4)
            poses.append(Tr_inv @ Tc @ Tr)
        return poses

    def __len__(self):
        return len(self.scan_files)

    @property
    def cam_names(self):
        return [self.CAM] if (self.K is not None and self.img_files) else []

    def gt_poses(self):
        return self._gt

    def _correct_scan(self, pts: np.ndarray) -> np.ndarray:
        """Vertical-angle correction (reference kitti.py; also KISS-ICP)."""
        ang = np.radians(self.correction_deg)
        r = np.linalg.norm(pts, axis=1)
        z_off = np.sin(ang) * r
        corr = pts.copy()
        corr[:, 2] += z_off
        return corr

    @staticmethod
    def _azimuth_ts(pts: np.ndarray) -> np.ndarray:
        az = np.arctan2(pts[:, 1], pts[:, 0])
        # KITTI spins clockwise starting at -x; normalize [0, 1]
        return ((-az + np.pi) / (2 * np.pi)).astype(np.float32)

    def __getitem__(self, idx: int) -> dict:
        pts = np.fromfile(self.scan_files[idx],
                          dtype=np.float32).reshape(-1, 4)[:, :3]
        if self.apply_correction:
            pts = self._correct_scan(pts)
        out = {
            "points": pts.astype(np.float32),
            "point_ts": self._azimuth_ts(pts),
        }
        if self.sem_files:
            # SemanticKITTI .label: u32 per point, class id in low 16 bits.
            # Raw ids (road=40, building=50, moving-car=252, ...) are
            # reduced to the 20-class training-id space so they index the
            # sem_class_count softmax; outliers (raw <= 1) become -1
            # (excluded from supervision, reference filter_sem_kitti
            # slam_dataset.py:1670-1690), and moving objects (raw >= 100)
            # are ignored too when cfg.filter_moving_object is set.
            lab = np.fromfile(self.sem_files[idx], dtype=np.uint32)
            if len(lab) == len(pts):
                raw = (lab & 0xFFFF).astype(np.int32)
                sem = SEM_KITTI_LEARNING_MAP[np.clip(raw, 0, 259)]
                if self.filter_moving:
                    sem = np.where(raw >= 100, -1, sem)
                out["sem"] = sem.astype(np.int32)
        if idx < len(self.img_files) and self.K is not None:
            img = imread_rgb(self.img_files[idx])
            out["img"] = {self.CAM: img}
            out["K"] = {self.CAM: self.K}
            out["T_c_l"] = {self.CAM: self.T_c_l}
        if self._gt is not None and idx < len(self._gt):
            out["gt_pose"] = self._gt[idx]
        return out


@register_loader("kitti_mot")
class KittiMotDataset(BaseDataset):
    """KITTI tracking/MOT layout (reference kitti_mot.py):
    data_tracking_velodyne/<split>/velodyne/<seq>/*.bin +
    data_tracking_image_2/.../image_02/<seq> +
    data_tracking_calib/<split>/calib/<seq>.txt. sequence:
    '<seq>[:<split>]' (split defaults to 'training')."""

    CAM = "cam2"

    def __init__(self, data_path: str, sequence: str = "0000", cfg=None):
        super().__init__(data_path, sequence, cfg)
        parts = (sequence or "0000").split(":")
        seq = parts[0].zfill(4)
        split = parts[1] if len(parts) > 1 else "training"
        self.scan_files = sorted(glob.glob(os.path.join(
            data_path, "data_tracking_velodyne", split, "velodyne", seq,
            "*.bin")))
        self.img_files = sorted(glob.glob(os.path.join(
            data_path, "data_tracking_image_2", split, "image_02", seq,
            "*.png")))
        self.K = None
        self.T_c_l = None
        calib = os.path.join(data_path, "data_tracking_calib", split,
                             "calib", f"{seq}.txt")
        if os.path.exists(calib):
            self._load_tracking_calib(calib)
        self._gt = None

    def _load_tracking_calib(self, path: str):
        """P2 + R_rect + Tr_velo_cam -> K2, T_c2_l (reference
        kitti_mot.py:181-249)."""
        rows = []
        with open(path) as f:
            for line in f:
                vals = line.split()[1:]
                if vals:
                    rows.append(np.array([float(v) for v in vals]))
        P2 = rows[2].reshape(3, 4)
        self.K = P2[:, :3].copy()
        T_c2_r = np.eye(4)
        T_c2_r[:3, 3] = np.linalg.inv(self.K) @ P2[:, 3]
        T_r_c = np.eye(4)
        T_r_c[:3, :3] = rows[4].reshape(3, 3)
        T_c_l = np.eye(4)
        T_c_l[:3, :4] = rows[5].reshape(3, 4)
        self.T_c_l = T_c2_r @ T_r_c @ T_c_l

    def __len__(self):
        return len(self.scan_files)

    @property
    def cam_names(self):
        return [self.CAM] if (self.K is not None and self.img_files) else []

    def __getitem__(self, idx: int) -> dict:
        pts = np.fromfile(self.scan_files[idx],
                          dtype=np.float32).reshape(-1, 4)[:, :3]
        out = {"points": pts, "point_ts": KittiDataset._azimuth_ts(pts)}
        if idx < len(self.img_files) and self.K is not None:
            img = imread_rgb(self.img_files[idx])
            out["img"] = {self.CAM: img}
            out["K"] = {self.CAM: self.K}
            out["T_c_l"] = {self.CAM: self.T_c_l}
        return out
