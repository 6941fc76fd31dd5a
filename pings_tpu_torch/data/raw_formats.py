"""Loaders for extracted "raw sensor folder" datasets: VBR, R3LIVE,
IPB-Car, Oxford-Spires, Waymo (extracted), CKA, AgriSLAM.

Reference: dataset/dataloaders/{vbr,r3live,ipb_car,oxford,waymo,cka,
agri_slam}.py. All of these store one folder per sensor
(``<sensor>/data/*.{bin,ply,png,jpg}`` + ``timestamps.txt`` with ISO
datetimes) plus a calibration yaml/json and a GT pose file. Color
projection onto LiDAR points is NOT done here — the pipeline's
project_points_to_cams handles it (reference does it in-loader,
slam_dataset.py:803-857 does it again per-frame).

A copy of ``pings_tpu/data/raw_formats.py``: the port imports nothing of the JAX
package. Images are read by ``data/rgbd.read_rgb`` (PNG in numpy, JPEG through
OpenCV where it is installed, else a raise).
"""

from __future__ import annotations

import glob
import json
import os
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np

from pings_tpu_torch.data.base import BaseDataset, register_loader
from pings_tpu_torch.data.pointcloud_io import read_pcd, read_ply
from pings_tpu_torch.data.rgbd import read_rgb
from pings_tpu_torch.eval.traj import read_kitti_poses, read_tum_poses
from pings_tpu_torch.utils.pose import quat_xyzw_to_rotmat


def read_iso_timestamps(path: str) -> np.ndarray:
    """timestamps.txt with ISO datetimes (reference ipb_car.py:301-318)
    or plain float seconds, one per line."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if "T" in line:
                dt_str, _, frac = line.partition(".")
                ns = (frac[:9].ljust(9, "0")) if frac else "0"
                dt = datetime.strptime(dt_str, "%Y-%m-%dT%H:%M:%S")
                sec = (dt - datetime(1970, 1, 1)).total_seconds()
                out.append(sec + int(ns) * 1e-9)
            else:
                out.append(float(line))
    return np.asarray(out)


def associate(ref_ts: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Index of the nearest entry in ts for each ref_ts (reference
    associate_img_to_lidar, vbr.py:115-127)."""
    if len(ts) == 0:
        return np.zeros(len(ref_ts), np.int32)
    return np.array([int(np.argmin(np.abs(ts - t))) for t in ref_ts],
                    np.int32)


def _read_img(path: str) -> np.ndarray:
    return read_rgb(path)


class _RawFolderBase(BaseDataset):
    """Common logic: scan list + per-camera associated image lists."""

    scan_files: List[str]
    scan_ts: np.ndarray
    cams: Dict[str, dict]        # name -> {files, K, T_c_l}
    _gt: Optional[List[np.ndarray]] = None

    def __len__(self):
        return len(self.scan_files)

    @property
    def cam_names(self):
        return list(self.cams)

    def gt_poses(self):
        return self._gt

    def _read_scan(self, path: str):
        if path.endswith(".bin"):
            pts = np.fromfile(path, np.float32).reshape(-1, 4)[:, :3]
            return pts, None
        data = read_ply(path) if path.endswith(".ply") else read_pcd(path)
        ts = data.get("time")
        if ts is not None and ts.max() > ts.min():
            ts = (ts - ts.min()) / (ts.max() - ts.min())
        return data["xyz"], ts

    def __getitem__(self, idx: int) -> dict:
        pts, ts = self._read_scan(self.scan_files[idx])
        out: dict = {"points": pts}
        if ts is not None:
            out["point_ts"] = ts
        if len(self.scan_ts):
            out["sensor_ts"] = float(self.scan_ts[idx])
        if self.cams:
            imgs, Ks, Ts = {}, {}, {}
            for name, cam in self.cams.items():
                files = cam["files"]
                if idx < len(files):
                    imgs[name] = _read_img(files[idx])
                    Ks[name] = cam["K"]
                    Ts[name] = cam["T_c_l"]
            if imgs:
                out["img"] = imgs
                out["K"] = Ks
                out["T_c_l"] = Ts
        if self._gt is not None and idx < len(self._gt):
            out["gt_pose"] = self._gt[idx]
        return out


@register_loader("vbr")
class VBRDataset(_RawFolderBase):
    """VBR: ouster_points/data/*.bin + camera_left + vbr_calib.yaml +
    gt.txt (TUM format) (reference vbr.py)."""

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        root = os.path.join(data_path, sequence) if sequence else data_path
        self.scan_files = sorted(
            glob.glob(os.path.join(root, "ouster_points", "data", "*.bin")))
        ts_file = os.path.join(root, "ouster_points", "timestamps.txt")
        self.scan_ts = read_iso_timestamps(ts_file) \
            if os.path.exists(ts_file) else np.array([])
        self.cams = {}
        cam_dir = os.path.join(root, "camera_left")
        calib_file = os.path.join(root, "vbr_calib.yaml")
        if os.path.isdir(cam_dir) and os.path.exists(calib_file):
            import yaml

            calib = yaml.safe_load(open(calib_file))
            cl = calib["cam_l"]
            fx, fy, cx, cy = cl["intrinsics"]
            K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
            T_c_l = np.linalg.inv(np.asarray(cl["T_b"], np.float64))
            files = sorted(glob.glob(os.path.join(cam_dir, "data", "*.png")))
            img_ts = read_iso_timestamps(
                os.path.join(cam_dir, "timestamps.txt"))
            sel = associate(self.scan_ts, img_ts) \
                if len(self.scan_ts) and len(img_ts) else \
                np.arange(min(len(files), len(self.scan_files)))
            self.cams["camera_left"] = {
                "files": [files[i] for i in sel], "K": K, "T_c_l": T_c_l}
        gt_file = os.path.join(root, "gt.txt")
        if os.path.exists(gt_file) and len(self.scan_ts):
            poses, pts = read_tum_poses(gt_file)
            sel = associate(self.scan_ts, np.asarray(pts))
            self._gt = [poses[i] for i in sel]


@register_loader("r3live")
class R3LiveDataset(_RawFolderBase):
    """R3LIVE extracted bags: livox_points/data/*.bin +
    camera_image_color_compressed (reference r3live.py; fixed Livox
    Avia intrinsics/extrinsics from the R3LIVE config)."""

    # reference r3live.py hard-coded calibration
    K = np.array([[863.4241, 0.0, 640.6808],
                  [0.0, 863.4171, 518.3392], [0.0, 0.0, 1.0]])
    R_CL = np.array([[-0.00113207, -0.0158688, 0.999873],
                     [-0.9999999, -0.000486594, -0.00113994],
                     [0.000504622, -0.999874, -0.0158682]]).T
    T_CL = np.array([0.050166, 0.0474116, -0.0312415])

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        root = os.path.join(data_path, sequence) if sequence else data_path
        self.scan_files = sorted(
            glob.glob(os.path.join(root, "livox_points", "data", "*.bin")))
        ts_file = os.path.join(root, "livox_points", "timestamps.txt")
        self.scan_ts = read_iso_timestamps(ts_file) \
            if os.path.exists(ts_file) else np.array([])
        self.cams = {}
        cam_dir = os.path.join(root, "camera_image_color_compressed")
        if os.path.isdir(cam_dir):
            files = sorted(glob.glob(os.path.join(cam_dir, "data", "*.png")))
            ts2 = os.path.join(cam_dir, "timestamps.txt")
            img_ts = read_iso_timestamps(ts2) if os.path.exists(ts2) \
                else np.array([])
            sel = associate(self.scan_ts, img_ts) \
                if len(self.scan_ts) and len(img_ts) else \
                np.arange(min(len(files), len(self.scan_files)))
            T_c_l = np.eye(4)
            T_c_l[:3, :3] = self.R_CL
            T_c_l[:3, 3] = self.T_CL
            self.cams["cam"] = {"files": [files[i] for i in sel],
                                "K": self.K, "T_c_l": T_c_l}


@register_loader("ipb_car")
class IPBCarDataset(_RawFolderBase):
    """IPB car: lidar_horizontal_points/data/*.ply (t field) + 4 cameras
    + calibration/results.yaml + poses_pin_slam.txt (reference
    ipb_car.py). sequence: '' | 'both_lidars' | comma cam list."""

    CAM_LIST = ["left", "right", "front", "rear"]

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        root = data_path
        self.use_both = sequence == "both_lidars"
        self.scan_files = sorted(glob.glob(
            os.path.join(root, "lidar_horizontal_points", "data", "*.ply")))
        ts_file = os.path.join(root, "lidar_horizontal_points",
                               "timestamps.txt")
        self.scan_ts = read_iso_timestamps(ts_file) \
            if os.path.exists(ts_file) else np.array([])
        self.v_files = sorted(glob.glob(
            os.path.join(root, "lidar_vertical_points", "data", "*.ply"))) \
            if self.use_both else []

        self.cams = {}
        self.T_lv_lh = np.eye(4)
        calib_file = os.path.join(root, "calibration", "results.yaml")
        if os.path.exists(calib_file):
            import yaml

            calib = yaml.safe_load(open(calib_file))
            T_cf_lh = np.asarray(
                calib["lidarhorizontalpoints"]["extrinsics"], np.float64)
            if "lidarverticalpoints" in calib:
                T_cf_lv = np.asarray(
                    calib["lidarverticalpoints"]["extrinsics"], np.float64)
                self.T_lv_lh = np.linalg.inv(T_cf_lv) @ T_cf_lh
            for cam in self.CAM_LIST:
                key = f"camera{cam}image_raw"
                cam_dir = os.path.join(root, f"camera_{cam}")
                if key not in calib or not os.path.isdir(cam_dir):
                    continue
                cc = calib[key]
                und = os.path.join(cam_dir, "data_undistorted")
                files = sorted(glob.glob(os.path.join(
                    und if os.path.isdir(und) else
                    os.path.join(cam_dir, "data"), "*.png")))
                img_ts_f = os.path.join(cam_dir, "timestamps.txt")
                img_ts = read_iso_timestamps(img_ts_f) \
                    if os.path.exists(img_ts_f) else np.array([])
                sel = associate(self.scan_ts, img_ts) \
                    if len(self.scan_ts) and len(img_ts) else \
                    np.arange(min(len(files), len(self.scan_files)))
                self.cams[cam] = {
                    "files": [files[i] for i in sel],
                    "K": np.asarray(cc["K"], np.float64),
                    "T_c_l": np.linalg.inv(
                        np.asarray(cc["extrinsics"], np.float64)) @ T_cf_lh,
                }
        pose_file = os.path.join(root, "poses_pin_slam.txt")
        if os.path.exists(pose_file):
            self._gt = read_kitti_poses(pose_file)

    def __getitem__(self, idx: int) -> dict:
        out = super().__getitem__(idx)
        pts = out["points"]
        keep = ~np.all(np.abs(pts) < 0.5, axis=1)
        for k in ("points", "point_ts"):
            if k in out:
                out[k] = out[k][keep]
        out["point_lidar_idx"] = np.zeros(len(out["points"]), np.int32)
        if self.use_both and idx < len(self.v_files):
            vpts, vts = self._read_scan(self.v_files[idx])
            vpts = (vpts @ self.T_lv_lh[:3, :3].T
                    + self.T_lv_lh[:3, 3]).astype(np.float32)
            out["points"] = np.concatenate([out["points"], vpts])
            if "point_ts" in out and vts is not None:
                out["point_ts"] = np.concatenate([out["point_ts"], vts])
            out["point_lidar_idx"] = np.concatenate(
                [out["point_lidar_idx"], np.ones(len(vpts), np.int32)])
        return out


@register_loader("oxford")
class OxfordSpiresDataset(_RawFolderBase):
    """Oxford-Spires processed: vilens-slam/undist-clouds/*.pcd +
    trajectory/gt-tum.txt + colmap rectified multicam (reference
    oxford.py)."""

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        root = os.path.join(data_path, sequence) if sequence else data_path
        proc = os.path.join(root, "processed")
        self.scan_files = sorted(glob.glob(os.path.join(
            proc, "vilens-slam", "undist-clouds", "*.pcd")))
        self.scan_ts = np.array(
            [self._stamp(f) for f in self.scan_files])
        self.cams = {}
        img_base = os.path.join(proc, "colmap", "images_rectified")
        calib_file = os.path.join(os.path.dirname(root.rstrip("/")),
                                  "calibration", "cam-lidar-imu.yaml")
        calib = None
        if os.path.exists(calib_file):
            import yaml

            calib = yaml.safe_load(open(calib_file))
        for i in range(3):
            cam = f"cam{i}"
            d = os.path.join(
                img_base,
                f"alphasense_driver_ros_{cam}_debayered_image_compressed")
            files = sorted(glob.glob(os.path.join(d, "*.jpg")))
            if not files:
                continue
            img_ts = np.array([self._stamp(f) for f in files])
            sel = associate(self.scan_ts, img_ts) if len(self.scan_ts) \
                else np.arange(len(files))
            K = np.eye(3)
            T_c_l = np.eye(4)
            if calib is not None and cam in calib:
                c = calib[cam]
                if "intrinsics" in c:
                    fx, fy, cx, cy = c["intrinsics"]
                    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
                if "T_cam_lidar" in c:
                    T_c_l = np.asarray(c["T_cam_lidar"], np.float64)
            self.cams[cam] = {"files": [files[i] for i in sel], "K": K,
                              "T_c_l": T_c_l}
        gt_file = os.path.join(proc, "trajectory", "gt-tum.txt")
        if os.path.exists(gt_file) and len(self.scan_ts):
            poses, pts = read_tum_poses(gt_file)
            sel = associate(self.scan_ts, np.asarray(pts))
            self._gt = [poses[i] for i in sel]

    @staticmethod
    def _stamp(path: str) -> float:
        stem = os.path.splitext(os.path.basename(path))[0]
        parts = stem.replace("cloud_", "").split("_")
        try:
            if len(parts) == 2:
                return int(parts[0]) + int(parts[1]) * 1e-9
            return float(parts[0])
        except ValueError:
            return 0.0


@register_loader("cka")
class CKADataset(_RawFolderBase):
    """CKA agricultural RGB-D: color/*.png + depth/*.npy +
    intrinsic.json + poses_metashape.npz or poses/*.txt (reference
    cka.py)."""

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        root = os.path.join(data_path, sequence) if sequence else data_path
        self.rgb_files = sorted(glob.glob(os.path.join(root, "color",
                                                       "*.png")))
        self.depth_files = sorted(glob.glob(os.path.join(root, "depth",
                                                         "*.npy")))
        self.scan_files = self.depth_files   # depth is the ranging sensor
        self.scan_ts = np.array([])
        self.depth_scale = 1.0
        K = np.eye(3)
        intr = os.path.join(root, "intrinsic.json")
        if os.path.exists(intr):
            d = json.load(open(intr))
            self.depth_scale = d.get("depth_scale", 1.0)
            K = np.array([[d["fx"], 0, d["cx"]],
                          [0, d["fy"], d["cy"]], [0, 0, 1.0]])
        self.K = K
        self.cams = {"cam": {"files": self.rgb_files, "K": K,
                             "T_c_l": np.eye(4)}}
        npz = os.path.join(root, "poses_metashape.npz")
        if os.path.exists(npz):
            data = np.load(npz)
            key = "poses" if "poses" in data else list(data.keys())[0]
            self._gt = [p for p in data[key]]
        else:
            pose_files = sorted(glob.glob(os.path.join(root, "poses",
                                                       "*.txt")))
            if pose_files:
                self._gt = [np.loadtxt(f).reshape(4, 4)
                            for f in pose_files]

    def __getitem__(self, idx: int) -> dict:
        from pings_tpu_torch.data.rgbd import backproject

        depth = np.load(self.depth_files[idx]).astype(np.float32) \
            / self.depth_scale
        img = _read_img(self.rgb_files[idx])
        stride = 2 if depth.size > 400000 else 1
        pts, (pys, pxs) = backproject(depth, self.K, stride=stride)
        rgb = img[pys, pxs].astype(np.float32) / 255.0
        out = {
            "points": np.concatenate([pts, rgb], axis=1),
            "img": {"cam": img},
            "depth": {"cam": depth},
            "K": {"cam": self.K},
            "T_c_l": {"cam": np.eye(4)},
        }
        if self._gt is not None and idx < len(self._gt):
            out["gt_pose"] = self._gt[idx]
        return out


@register_loader("waymo")
class WaymoDataset(_RawFolderBase):
    """Waymo (pre-extracted): lidars/<name>/*.pcd + images_ud/<cam>/*.jpg
    + masks + transform.json (reference waymo.py; works on the
    PINGS-extracted folder format, not raw TFRecords)."""

    LIDARS = ["lidar_TOP", "lidar_FRONT", "lidar_REAR",
              "lidar_SIDE_LEFT", "lidar_SIDE_RIGHT"]
    CAMS = ["cam_FRONT", "cam_FRONT_LEFT", "cam_FRONT_RIGHT",
            "cam_SIDE_LEFT", "cam_SIDE_RIGHT"]

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        root = os.path.join(data_path, sequence) if sequence else data_path
        self.scan_files = sorted(glob.glob(
            os.path.join(root, "lidars", self.LIDARS[0], "*.pcd")))
        self.aux_lidars = {
            name: sorted(glob.glob(os.path.join(root, "lidars", name,
                                                "*.pcd")))
            for name in self.LIDARS[1:]}
        self.scan_ts = np.array([])
        img_dir = os.path.join(root, "images_ud")
        if not os.path.isdir(img_dir):
            img_dir = os.path.join(root, "images")
        self.cams = {}
        tf_file = os.path.join(root, "transform.json")
        tf = json.load(open(tf_file)) if os.path.exists(tf_file) else {}
        lidar_top_ext = np.asarray(
            tf.get("lidar_TOP", {}).get("extrinsic", np.eye(4)))
        for cam in self.CAMS:
            files = sorted(glob.glob(os.path.join(img_dir, cam, "*.jpg")))
            if not files or cam not in tf:
                continue
            K = np.asarray(tf[cam]["camera_intrinsic"])
            T_c_l = np.linalg.inv(np.asarray(tf[cam]["extrinsic"])) \
                @ lidar_top_ext
            self.cams[cam] = {"files": files, "K": K, "T_c_l": T_c_l}
        if "gt_poses" in tf:
            poses = np.asarray(tf["gt_poses"])
            self._gt = [p for p in np.linalg.inv(poses[0]) @ poses]

    def __getitem__(self, idx: int) -> dict:
        out = super().__getitem__(idx)
        extra = []
        for name, files in self.aux_lidars.items():
            if idx < len(files):
                extra.append(read_pcd(files[idx])["xyz"])
        if extra:
            out["points"] = np.concatenate([out["points"]] + extra)
        return out


@register_loader("agri_slam")
class AgriSLAMDataset(_RawFolderBase):
    """AgriSLAM field-robot sequences: ouster pcd folder + stereo RGB +
    poses csv (timestamp,tx..qw) (reference agri_slam.py)."""

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        root = os.path.join(data_path, sequence) if sequence else data_path
        self.scan_files = (
            sorted(glob.glob(os.path.join(root, "ouster", "*.pcd")))
            or sorted(glob.glob(os.path.join(root, "lidar", "*.pcd")))
            or sorted(glob.glob(os.path.join(root, "ouster_points",
                                             "data", "*.bin"))))
        self.scan_ts = np.array([])
        self.cams = {}
        for cam in ("camera_left", "cam0", "rgb"):
            d = os.path.join(root, cam)
            files = sorted(glob.glob(os.path.join(d, "*.png")) +
                           glob.glob(os.path.join(d, "*.jpg")))
            if files:
                self.cams[cam] = {"files": files, "K": np.eye(3),
                                  "T_c_l": np.eye(4)}
                break
        pose_file = os.path.join(root, "poses.csv")
        if os.path.exists(pose_file):
            raw = np.genfromtxt(pose_file, delimiter=",",
                                skip_header=1)
            if raw.ndim == 2 and raw.shape[1] >= 8:
                poses = np.tile(np.eye(4), (len(raw), 1, 1))
                poses[:, :3, :3] = quat_xyzw_to_rotmat(raw[:, 4:8])
                poses[:, :3, 3] = raw[:, 1:4]
                self._gt = [p for p in np.linalg.inv(poses[0]) @ poses]


@register_loader("oxford_raw")
class OxfordRawDataset(OxfordSpiresDataset):
    """Raw (non-'processed') Oxford-Spires layout (reference
    oxford_raw.py): same sensors, folders at the sequence root."""

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        BaseDataset.__init__(self, data_path, sequence, cfg)
        root = os.path.join(data_path, sequence) if sequence else data_path
        self.scan_files = (
            sorted(glob.glob(os.path.join(root, "lidar", "*.pcd")))
            or sorted(glob.glob(os.path.join(root, "ouster_scan", "*.pcd"))))
        self.scan_ts = np.array([self._stamp(f) for f in self.scan_files])
        self.cams = {}
        for i in range(3):
            cam = f"cam{i}"
            d = os.path.join(root, "images", cam)
            files = sorted(glob.glob(os.path.join(d, "*.jpg")) +
                           glob.glob(os.path.join(d, "*.png")))
            if files:
                self.cams[cam] = {"files": files, "K": np.eye(3),
                                  "T_c_l": np.eye(4)}
        gt_file = os.path.join(root, "gt-tum.txt")
        if os.path.exists(gt_file) and len(self.scan_ts):
            poses, pts = read_tum_poses(gt_file)
            sel = associate(self.scan_ts, np.asarray(pts))
            self._gt = [poses[i] for i in sel]
