"""LiDAR-only dataset loaders: MulRan, Newer College, NCLT, Apollo,
HeLiPR.

Reference: dataset/dataloaders/{mulran,ncd,nclt,apollo,helipr}.py. Each
produces the standard frame dict (see data/base.py); poses are normalized
to the LiDAR frame with the first pose at identity, matching the
reference conventions.

A copy of ``pings_tpu/data/lidar.py``: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import glob
import os
import struct
from typing import List, Optional

import numpy as np

from pings_tpu_torch.data.base import BaseDataset, register_loader
from pings_tpu_torch.data.pointcloud_io import read_pcd, read_ply
from pings_tpu_torch.utils.pose import quat_xyzw_to_rotmat


def _local_poses(poses: np.ndarray) -> np.ndarray:
    """Re-anchor (M,4,4) world poses so pose[0] = identity."""
    return np.linalg.inv(poses[0]) @ poses


def _poses_from_quat_rows(xyz: np.ndarray, qxyzw: np.ndarray) -> np.ndarray:
    n = xyz.shape[0]
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :3] = quat_xyzw_to_rotmat(qxyzw)
    poses[:, :3, 3] = xyz
    return poses


def _spin_timestamps(n_beams: int, n_azimuth: int) -> np.ndarray:
    """Column-major Ouster range-image timestamps (reference
    mulran.py:60-64): all beams of one azimuth column share a time."""
    return (np.floor(np.arange(n_beams * n_azimuth) / n_beams)
            / n_azimuth).astype(np.float64)


def _azimuth_timestamps(pts: np.ndarray) -> np.ndarray:
    """Per-point normalized time from clockwise spin azimuth (reference
    apollo.py:73-79)."""
    yaw = -np.arctan2(pts[:, 1], pts[:, 0])
    return (0.5 * (yaw / np.pi + 1.0)).astype(np.float64)


@register_loader("mulran")
class MulranDataset(BaseDataset):
    """MulRan: Ouster/*.bin (xyzi f32, 64x1024), global_pose.csv
    (reference mulran.py)."""

    # base_link <- ouster extrinsics (reference mulran.py:93-106)
    T_B_L = np.array([
        [-9.9998295e-01, -5.8398386e-03, -5.2257060e-06, 1.7042],
        [5.8398386e-03, -9.9998295e-01, 1.7758769e-06, -0.021],
        [-5.2359878e-06, 1.7453292e-06, 1.0, 1.8047],
        [0.0, 0.0, 0.0, 1.0]])

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        seq_dir = os.path.join(data_path, sequence) if sequence else data_path
        self.scan_files = sorted(
            glob.glob(os.path.join(seq_dir, "Ouster", "*.bin")))
        self._ts = [int(os.path.basename(f).split(".")[0])
                    for f in self.scan_files]
        self._gt = None
        pose_file = os.path.join(seq_dir, "global_pose.csv")
        if os.path.exists(pose_file):
            self._gt = self._load_gt(pose_file)

    def _load_gt(self, path: str) -> List[np.ndarray]:
        raw = np.loadtxt(path, delimiter=",")
        stamps, flat = raw[:, 0], raw[:, 1:13]
        poses = np.tile(np.eye(4), (len(raw), 1, 1))
        poses[:, :3, :4] = flat.reshape(-1, 3, 4)
        poses = poses[[int(np.argmin(np.abs(stamps - t)))
                       for t in self._ts]]
        poses = _local_poses(poses)
        # base-frame poses -> lidar frame
        return list(self.T_B_L @ poses @ np.linalg.inv(self.T_B_L))

    def __len__(self):
        return len(self.scan_files)

    def gt_poses(self):
        return self._gt

    def __getitem__(self, idx: int) -> dict:
        pts = np.fromfile(self.scan_files[idx],
                          dtype=np.float32).reshape(-1, 4)[:, :3]
        ts = _spin_timestamps(64, 1024)
        if len(ts) != len(pts):
            ts = np.ones(len(pts))
        return {"points": pts, "point_ts": ts,
                "sensor_ts": self._ts[idx] * 1e-9}


@register_loader("ncd")
class NewerCollegeDataset(BaseDataset):
    """Newer College raw: raw_format/ouster_scan/cloud_*.pcd +
    ground_truth/registered_poses.csv (reference ncd.py)."""

    # cam <- lidar used to re-frame gt poses (reference ncd.py:108-111)
    _Q_CL = np.array([0.0, 0.0, 0.924, 0.383])      # xyzw
    _T_CL = np.array([-0.084, -0.025, 0.050])

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        seq_dir = os.path.join(data_path, sequence) if sequence else data_path
        scan_dir = os.path.join(seq_dir, "raw_format", "ouster_scan")
        if not os.path.isdir(scan_dir):
            scan_dir = seq_dir

        def stamp(fn):
            m = os.path.basename(fn).split("_")
            return int(m[1]) * 10**9 + int(m[2].split(".")[0])

        self.scan_files = sorted(
            glob.glob(os.path.join(scan_dir, "cloud_*.pcd")), key=stamp)
        self._gt = None
        pose_file = os.path.join(seq_dir, "ground_truth",
                                 "registered_poses.csv")
        if os.path.exists(pose_file):
            raw = np.genfromtxt(pose_file, delimiter=",", dtype=np.float64)
            poses = _poses_from_quat_rows(raw[:, 2:5], raw[:, 5:9])
            T_cl = np.eye(4)
            T_cl[:3, :3] = quat_xyzw_to_rotmat(self._Q_CL[None])[0]
            T_cl[:3, 3] = self._T_CL
            poses = poses @ T_cl
            self._gt = list(_local_poses(poses))

    def __len__(self):
        return len(self.scan_files)

    def gt_poses(self):
        return self._gt

    def __getitem__(self, idx: int) -> dict:
        data = read_pcd(self.scan_files[idx])
        pts = data["xyz"]
        if "time" in data:
            t = data["time"]
            rng = t.max() - t.min()
            ts = (t - t.min()) / rng if rng > 0 else np.ones(len(pts))
        else:
            ts = _spin_timestamps(64, 1024)
            if len(ts) != len(pts):
                ts = np.ones(len(pts))
        return {"points": pts, "point_ts": ts}


@register_loader("nclt")
class NCLTDataset(BaseDataset):
    """NCLT velodyne_sync/*.bin (i16 x4 scaled) + groundtruth csv
    (reference nclt.py). Points are flipped to z-up velodyne frame."""

    Z_BODY_VEL = -0.957

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        seq_dir = os.path.join(data_path, sequence) if sequence else data_path
        self.scans_dir = os.path.join(seq_dir, "velodyne_sync")
        files = np.array(sorted(os.listdir(self.scans_dir)), dtype=str)
        seq_id = os.path.basename(os.path.normpath(seq_dir))
        pose_file = os.path.realpath(os.path.join(
            seq_dir, "..", "ground_truth", f"groundtruth_{seq_id}.csv"))
        self._gt: Optional[List[np.ndarray]] = None
        if os.path.exists(pose_file):
            gt = np.loadtxt(pose_file, delimiter=",")
            stamps = np.array([int(f.split(".")[0]) for f in files],
                              dtype=np.int64)
            keep = (stamps > gt[:, 0].min()) & (stamps < gt[:, 0].max())
            files, stamps = files[keep], stamps[keep]
            self._gt = self._interp_gt(gt, stamps)
        self.scan_files = [os.path.join(self.scans_dir, f) for f in files]

    @staticmethod
    def _interp_gt(gt: np.ndarray, stamps: np.ndarray) -> List[np.ndarray]:
        from scipy import interpolate
        from scipy.spatial.transform import Rotation

        inter = interpolate.interp1d(gt[:, 0], gt[:, 1:], kind="nearest",
                                     axis=0)
        vals = inter(stamps)
        rot = Rotation.from_euler(
            "ZYX", vals[:, 3:][:, [2, 1, 0]]).as_matrix()
        poses = np.tile(np.eye(4), (len(stamps), 1, 1))
        poses[:, :3, :3] = rot
        poses[:, :3, 3] = vals[:, :3]
        # NED body -> z-up on both sides (reference nclt.py:129-152)
        F = np.diag([1.0, -1.0, -1.0, 1.0])
        poses = F @ poses @ F
        return list(_local_poses(poses))

    def __len__(self):
        return len(self.scan_files)

    def gt_poses(self):
        return self._gt

    def __getitem__(self, idx: int) -> dict:
        raw = np.fromfile(self.scan_files[idx], dtype=np.int16)
        xyz = raw.reshape(-1, 4)[:, :3].astype(np.float32) * 0.005 - 100.0
        # body frame -> z-up velodyne frame (reference nclt.py:86-92)
        pts = np.stack([xyz[:, 0], -xyz[:, 1],
                        -xyz[:, 2] + self.Z_BODY_VEL], axis=-1)
        return {"points": pts}


@register_loader("apollo")
class ApolloDataset(BaseDataset):
    """Apollo-SouthBay: pcds/*.pcd + poses/gt_poses.txt (t idx xyz qxyzw)
    (reference apollo.py)."""

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        seq_dir = os.path.join(data_path, sequence) if sequence else data_path

        def numkey(f):
            stem = os.path.splitext(os.path.basename(f))[0]
            return (0, int(stem)) if stem.isdigit() else (1, stem)

        self.scan_files = sorted(
            glob.glob(os.path.join(seq_dir, "pcds", "*.pcd")), key=numkey)
        self._gt = None
        pose_file = os.path.join(seq_dir, "poses", "gt_poses.txt")
        if os.path.exists(pose_file):
            raw = np.loadtxt(pose_file)
            poses = _poses_from_quat_rows(raw[:, 2:5], raw[:, 5:9])
            self._gt = list(_local_poses(poses))

    def __len__(self):
        return len(self.scan_files)

    def gt_poses(self):
        return self._gt

    def __getitem__(self, idx: int) -> dict:
        pts = read_pcd(self.scan_files[idx])["xyz"]
        return {"points": pts, "point_ts": _azimuth_timestamps(pts)}


# HeLiPR per-sensor packed binary record layouts (reference
# helipr.py:73-90): struct format, intensity column, time column.
_HELIPR_FMT = {
    "Avia": ("fffBBBL", None, 6),
    "Aeva": ("ffffflBf", 7, 5),
    "Ouster": ("ffffIHHH", 3, 4),
    "Velodyne": ("ffffHf", 3, 5),
}


@register_loader("helipr")
class HeLiPRDataset(BaseDataset):
    """HeLiPR: LiDAR/<sensor>/*.bin packed structs + LiDAR_GT poses;
    sequence selects the sensor (reference helipr.py)."""

    def __init__(self, data_path: str, sequence: str = "Ouster", cfg=None):
        super().__init__(data_path, sequence, cfg)
        name = sequence or "Ouster"
        if name not in _HELIPR_FMT:
            raise ValueError(
                f"unknown HeLiPR sensor '{name}'; one of {list(_HELIPR_FMT)}")
        self.fmt, self.int_col, self.time_col = _HELIPR_FMT[name]
        scan_dir = os.path.join(data_path, "LiDAR", name)
        self.scan_files = sorted(
            glob.glob(os.path.join(scan_dir, "*.bin")),
            key=lambda f: int(os.path.splitext(os.path.basename(f))[0]))
        self._gt = None
        pose_file = os.path.join(data_path, "LiDAR_GT", f"{name}_gt.txt")
        if os.path.exists(pose_file):
            # ns timestamps exceed f64 precision: parse column 0 as int
            stamps, rows = [], []
            with open(pose_file) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 8:
                        stamps.append(int(float(parts[0]))
                                      if "." in parts[0] else int(parts[0]))
                        rows.append([float(x) for x in parts[1:8]])
            raw = np.asarray(rows)
            stamps = np.asarray(stamps, dtype=np.int64)
            scan_stamps = {int(os.path.splitext(os.path.basename(f))[0])
                           for f in self.scan_files}
            keep = np.array([int(t) in scan_stamps for t in stamps])
            poses = _poses_from_quat_rows(raw[keep, 0:3], raw[keep, 3:7])
            self._gt = list(poses)
            kept = set(stamps[keep].tolist())
            self.scan_files = [
                f for f in self.scan_files
                if int(os.path.splitext(os.path.basename(f))[0]) in kept]

    def __len__(self):
        return len(self.scan_files)

    def gt_poses(self):
        return self._gt

    def __getitem__(self, idx: int) -> dict:
        size = struct.calcsize(f"={self.fmt}")
        with open(self.scan_files[idx], "rb") as f:
            buf = f.read()
        n = len(buf) // size
        rows = [struct.unpack_from(f"={self.fmt}", buf, i * size)
                for i in range(n)]
        data = np.asarray(rows, dtype=np.float64)
        pts = data[:, :3].astype(np.float32)
        t = data[:, self.time_col]
        rng = t.max() - t.min()
        ts = (t - t.min()) / rng if rng > 0 else np.ones(len(pts))
        return {"points": pts, "point_ts": ts}
