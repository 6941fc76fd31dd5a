"""RGB-D dataset loaders: Replica, TUM, Bonn, Azure Kinect, NeuralRGBD.

A copy of ``pings_tpu/data/rgbd.py``: ``backproject`` (:22), ``_RGBDBase``
(:33), ``ReplicaDataset`` (:76), ``TumDataset`` (:103), ``BonnDataset``
(:155), ``AzureDataset`` (:167) and ``NeuralRGBDDataset`` (:198). A frame's
depth map is back-projected into the camera-frame point cloud that
``process_frame`` takes as its scan (every second pixel above 400,000
pixels), coloured from the image; the camera is the sensor (``T_c_l`` =
identity).

PNG files (colour and 16-bit depth) are read by ``data/imageio``, which
gives the arrays ``cv2.imread`` gives. A JPEG colour frame (Replica's
``frame*.jpg``, Azure's ``color/*.jpg``) is decoded by OpenCV where it is
installed, else the loader raises: ``scripts/torch_make_replica_data.py``
writes the synthetic room with PNG colour frames.
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np

from pings_tpu_torch.data.base import BaseDataset, register_loader
from pings_tpu_torch.data.imageio import imread_rgb, read_png
from pings_tpu_torch.eval.traj import read_kitti_poses, read_tum_poses


def backproject(depth: np.ndarray, K: np.ndarray, stride: int = 1):
    h, w = depth.shape
    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    d = depth[::stride, ::stride]
    ok = d > 1e-4
    x = (xs + 0.5 - K[0, 2]) / K[0, 0] * d
    y = (ys + 0.5 - K[1, 2]) / K[1, 1] * d
    pts = np.stack([x[ok], y[ok], d[ok]], -1).astype(np.float32)
    return pts, (ys[ok], xs[ok])


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a colour frame: PNG in numpy, any other
    format (JPEG) through OpenCV, which must then be installed."""
    if path.lower().endswith(".png"):
        return imread_rgb(path)
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{path}: reading a non-PNG colour frame needs OpenCV (cv2), "
            "which is not installed; write the synthetic room with PNG "
            "frames by scripts/torch_make_replica_data.py") from e
    img = cv2.imread(path)
    if img is None:
        raise ValueError(f"{path}: OpenCV cannot read this image")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class _RGBDBase(BaseDataset):
    """Common RGB-D logic; subclasses set file lists, K, depth scale."""

    CAM = "cam"
    depth_scale = 1000.0
    K: np.ndarray

    rgb_files: List[str]
    depth_files: List[str]

    def __len__(self):
        return min(len(self.rgb_files), len(self.depth_files))

    @property
    def cam_names(self):
        return [self.CAM]

    def __getitem__(self, idx: int) -> dict:
        img = read_rgb(self.rgb_files[idx])
        depth_raw = read_png(self.depth_files[idx])
        depth = depth_raw.astype(np.float32) / self.depth_scale
        stride = 2 if depth.size > 400000 else 1
        pts, (pys, pxs) = backproject(depth, self.K, stride=stride)
        rgb = img[pys, pxs].astype(np.float32) / 255.0
        out = {
            "points": np.concatenate([pts, rgb], axis=1),
            "img": {self.CAM: img},
            "depth": {self.CAM: depth},
            "K": {self.CAM: self.K},
            "T_c_l": {self.CAM: np.eye(4)},
        }
        if self._gt is not None and idx < len(self._gt):
            out["gt_pose"] = self._gt[idx]
        return out

    def gt_poses(self):
        return self._gt


@register_loader("replica")
class ReplicaDataset(_RGBDBase):
    """Replica SLAM sequences: ``results/frame*.jpg`` (or ``rgb*.png``),
    ``results/depth*.png`` (metres x 6553.5) and ``traj.txt``; the Replica
    camera's intrinsics are fixed."""

    depth_scale = 6553.5

    def __init__(self, data_path: str, sequence: str = "room0", cfg=None):
        super().__init__(data_path, sequence, cfg)
        root = os.path.join(data_path, sequence)
        if not os.path.isdir(root):
            root = data_path
        res_dir = os.path.join(root, "results")
        if not os.path.isdir(res_dir):
            res_dir = root
        self.rgb_files = sorted(glob.glob(os.path.join(res_dir, "frame*.jpg"))
                                or glob.glob(os.path.join(res_dir, "rgb*.png")))
        self.depth_files = sorted(glob.glob(os.path.join(res_dir, "depth*.png")))
        self.K = np.array([[600.0, 0, 599.5], [0, 600.0, 339.5], [0, 0, 1]])
        self._gt = None
        traj = os.path.join(root, "traj.txt")
        if os.path.exists(traj):
            raw = np.loadtxt(traj).reshape(-1, 4, 4)
            self._gt = [raw[i] for i in range(len(raw))]


@register_loader("tum")
class TumDataset(_RGBDBase):
    """TUM RGB-D: rgb.txt/depth.txt associated by the nearest timestamp
    (within 20 ms); freiburg intrinsic presets chosen by the path."""

    depth_scale = 5000.0
    PRESETS = {
        "freiburg1": np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]]),
        "freiburg2": np.array([[520.9, 0, 325.1], [0, 521.0, 249.7], [0, 0, 1]]),
        "freiburg3": np.array([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]]),
    }

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        root = os.path.join(data_path, sequence) if sequence else data_path
        self.K = self.PRESETS["freiburg1"]
        for name, K in self.PRESETS.items():
            if name in root:
                self.K = K
        rgb_list = self._read_list(os.path.join(root, "rgb.txt"))
        depth_list = self._read_list(os.path.join(root, "depth.txt"))
        self.rgb_files, self.depth_files = [], []
        ts_gt: List[float] = []
        d_ts = np.array([t for t, _ in depth_list])
        for t, f in rgb_list:
            i = int(np.argmin(np.abs(d_ts - t)))
            if abs(d_ts[i] - t) < 0.02:
                self.rgb_files.append(os.path.join(root, f))
                self.depth_files.append(os.path.join(root, depth_list[i][1]))
                ts_gt.append(t)
        self._gt = None
        gt_file = os.path.join(root, "groundtruth.txt")
        if os.path.exists(gt_file):
            poses, pts = read_tum_poses(gt_file)
            pts_arr = np.array(pts)
            self._gt = [poses[int(np.argmin(np.abs(pts_arr - t)))]
                        for t in ts_gt]

    @staticmethod
    def _read_list(path: str):
        out = []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) >= 2:
                    out.append((float(parts[0]), parts[1]))
        return out


@register_loader("bonn")
class BonnDataset(TumDataset):
    """Bonn dynamic RGB-D: the TUM layout with depth scale 5000 and fixed
    intrinsics."""

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        self.K = np.array([[542.822841, 0, 315.593520],
                           [0, 542.576870, 237.756098], [0, 0, 1]])


@register_loader("azure")
class AzureDataset(_RGBDBase):
    """Azure Kinect captures: color/*.jpg (or *.png) + depth/*.png +
    intrinsic/intrinsic_color.txt + pose/*.txt."""

    depth_scale = 1000.0

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        root = os.path.join(data_path, sequence) if sequence else data_path
        self.rgb_files = sorted(
            glob.glob(os.path.join(root, "color", "*.jpg"))
            or glob.glob(os.path.join(root, "color", "*.png")))
        self.depth_files = sorted(
            glob.glob(os.path.join(root, "depth", "*.png")))
        intr = os.path.join(root, "intrinsic", "intrinsic_color.txt")
        if os.path.exists(intr):
            self.K = np.loadtxt(intr)[:3, :3]
        else:
            h, w = read_png(self.depth_files[0]).shape[:2]
            self.K = np.array([[550.0, 0, w / 2], [0, 550.0, h / 2],
                               [0, 0, 1]])
        self._gt = None
        pose_files = sorted(glob.glob(os.path.join(root, "pose", "*.txt")))
        if pose_files:
            self._gt = [np.loadtxt(f).reshape(4, 4) for f in pose_files]


@register_loader("neuralrgbd")
class NeuralRGBDDataset(_RGBDBase):
    """NeuralRGBD layout: images/ (or rgb/) + depth_filtered/ (or depth/),
    focal.txt, poses.txt (KITTI 3x4 rows)."""

    depth_scale = 1000.0

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        root = os.path.join(data_path, sequence) if sequence else data_path
        self.rgb_files = sorted(
            glob.glob(os.path.join(root, "images", "*.png"))
            or glob.glob(os.path.join(root, "rgb", "*.png")))
        self.depth_files = sorted(
            glob.glob(os.path.join(root, "depth_filtered", "*.png"))
            or glob.glob(os.path.join(root, "depth", "*.png")))
        focal_file = os.path.join(root, "focal.txt")
        focal = 554.0
        if os.path.exists(focal_file):
            with open(focal_file) as f:
                focal = float(f.read().split()[0])
        h, w = read_png(self.depth_files[0]).shape[:2]
        self.K = np.array([[focal, 0, w / 2 - 0.5],
                           [0, focal, h / 2 - 0.5], [0, 0, 1]])
        self._gt = None
        pose_file = os.path.join(root, "poses.txt")
        if os.path.exists(pose_file):
            self._gt = read_kitti_poses(pose_file)
