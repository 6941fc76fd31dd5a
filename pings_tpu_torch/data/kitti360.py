"""KITTI-360 loader (LiDAR + rectified left perspective camera).

Reference: dataset/dataloaders/kitti360.py (517 LoC): data_3d_raw
velodyne bins, data_2d_raw image_00/data_rect, calibration/ directory
(perspective.txt P_rect_00 + R_rect_00, calib_cam_to_pose.txt,
calib_cam_to_velo.txt), ground truth from IMU poses re-framed into the
LiDAR frame. This loader reads data_poses/<seq>/poses.txt (frame-indexed
IMU poses) instead of integrating raw OXTS packets; frames without a
pose entry take the nearest.

A copy of ``pings_tpu/data/kitti360.py``: the port imports nothing of the JAX
package. Images are read by ``data/rgbd.read_rgb`` (PNG in numpy, other formats
through OpenCV where it is installed).
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from pings_tpu_torch.data.base import BaseDataset, register_loader
from pings_tpu_torch.data.rgbd import read_rgb


def _seq_str(sequence: str) -> str:
    if sequence.startswith("2013_"):
        return sequence
    return f"2013_05_28_drive_{str(sequence).zfill(4)}_sync"


@register_loader("kitti360")
class Kitti360Dataset(BaseDataset):
    CAM = "cam_left_rect"
    W, H = 1408, 376

    def __init__(self, data_path: str, sequence: str = "0000", cfg=None):
        super().__init__(data_path, sequence, cfg)
        seq = _seq_str(sequence)
        self.lidar_dir = os.path.join(data_path, "data_3d_raw", seq,
                                      "velodyne_points", "data")
        self.img_dir = os.path.join(data_path, "data_2d_raw", seq,
                                    "image_00", "data_rect")
        self.scan_files = sorted(glob.glob(os.path.join(self.lidar_dir,
                                                        "*.bin")))
        self.img_files = sorted(glob.glob(os.path.join(self.img_dir,
                                                       "*.png")))
        calib = os.path.join(data_path, "calibration")
        self.K, self.T_c_l, self.T_l_imu = self._load_calib(calib)
        self._gt = self._load_poses(
            os.path.join(data_path, "data_poses", seq, "poses.txt"))

    def _load_calib(self, calib_dir: str):
        K = np.array([[552.554261, 0.0, 682.049453],
                      [0.0, 552.554261, 238.769549],
                      [0.0, 0.0, 1.0]])       # P_rect_00 defaults
        R_rect = np.eye(3)
        persp = os.path.join(calib_dir, "perspective.txt")
        if os.path.exists(persp):
            with open(persp) as f:
                for line in f:
                    key, _, val = line.partition(":")
                    if key.strip() == "P_rect_00":
                        P = np.array([float(x) for x in val.split()])
                        K = P.reshape(3, 4)[:, :3]
                    elif key.strip() == "R_rect_00":
                        R_rect = np.array(
                            [float(x) for x in val.split()]).reshape(3, 3)
        T_co_l = np.eye(4)                    # cam0 <- lidar
        c2v = os.path.join(calib_dir, "calib_cam_to_velo.txt")
        if os.path.exists(c2v):
            T_l_co = np.eye(4)
            T_l_co[:3, :4] = np.loadtxt(c2v).reshape(3, 4)
            T_co_l = np.linalg.inv(T_l_co)
        T_cr_co = np.eye(4)
        T_cr_co[:3, :3] = R_rect
        T_c_l = T_cr_co @ T_co_l              # rect cam <- lidar

        T_l_imu = np.eye(4)                   # lidar <- imu
        c2p = os.path.join(calib_dir, "calib_cam_to_pose.txt")
        if os.path.exists(c2p) and os.path.exists(c2v):
            with open(c2p) as f:
                for line in f:
                    key, _, val = line.partition(":")
                    if key.strip() == "image_00":
                        T_imu_co = np.eye(4)
                        T_imu_co[:3, :4] = np.array(
                            [float(x) for x in val.split()]).reshape(3, 4)
                        T_l_co = np.linalg.inv(T_co_l)
                        T_l_imu = T_l_co @ np.linalg.inv(T_imu_co)
        return K, T_c_l, T_l_imu

    def _load_poses(self, path: str):
        if not os.path.exists(path):
            return None
        raw = np.loadtxt(path)
        frame_ids = raw[:, 0].astype(int)
        mats = np.tile(np.eye(4), (len(raw), 1, 1))
        mats[:, :3, :4] = raw[:, 1:13].reshape(-1, 3, 4)
        # IMU world poses -> LiDAR frame, first = identity
        T = self.T_l_imu
        mats = T @ mats @ np.linalg.inv(T)
        mats = np.linalg.inv(mats[0]) @ mats
        poses = []
        for i in range(len(self.scan_files)):
            j = int(np.argmin(np.abs(frame_ids - i)))
            poses.append(mats[j])
        return poses

    def __len__(self):
        return len(self.scan_files)

    @property
    def cam_names(self):
        return [self.CAM] if self.img_files else []

    def gt_poses(self):
        return self._gt

    def __getitem__(self, idx: int) -> dict:
        pts = np.fromfile(self.scan_files[idx],
                          dtype=np.float32).reshape(-1, 4)[:, :3]
        yaw = -np.arctan2(pts[:, 1], pts[:, 0])
        ts = (0.5 * (yaw / np.pi + 1.0)).astype(np.float64)
        out = {"points": pts, "point_ts": ts}
        if idx < len(self.img_files):
            img = read_rgb(self.img_files[idx])
            out["img"] = {self.CAM: img}
            out["K"] = {self.CAM: self.K}
            out["T_c_l"] = {self.CAM: self.T_c_l}
        if self._gt is not None:
            out["gt_pose"] = self._gt[idx]
        return out
