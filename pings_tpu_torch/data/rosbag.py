"""Streaming loaders: ROS1 bags, MCAP, nuScenes (from the on-disk schema),
and the Ouster stub.

Reference loaders: dataset/dataloaders/rosbag.py (137), mcap.py (164),
mcap_ipb_car.py (601), nuscenes.py (405), ouster.py (160). The reference
depends on the `rosbags` / `mcap` / `nuscenes-devkit` packages; here the
container formats are parsed directly (data/bag_formats.py) and nuScenes
is read from its JSON schema — no optional dependencies. Ouster raw
streams genuinely require the vendor SDK for beam calibration and stay a
documented stub.

A copy of ``pings_tpu/data/rosbag.py``: the port imports nothing of the JAX
package. nuScenes' quaternions become rotation matrices in float32 numpy
(``_quat_to_rotmat_f32``), as the JAX package's ``quat_to_rotmat`` computes
them; its camera images are read by ``data/rgbd.read_rgb`` (PNG in numpy,
JPEG through OpenCV where it is installed).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from pings_tpu_torch.data.base import BaseDataset, register_loader
from pings_tpu_torch.data.bag_formats import (
    McapFile, Ros1Bag, decode_cdr_pointcloud2, decode_ros1_image,
    decode_ros1_pointcloud2, pointcloud_to_frame_points,
)
from pings_tpu_torch.data.rgbd import read_rgb

_PC2_TYPES = ("sensor_msgs/PointCloud2", "sensor_msgs/msg/PointCloud2")
_IMG_TYPES = ("sensor_msgs/Image", "sensor_msgs/msg/Image")


def _quat_to_rotmat_f32(q: np.ndarray) -> np.ndarray:
    """(w, x, y, z) -> 3x3 rotation matrix, in float32 as the JAX
    package's ``ops.transforms.quat_to_rotmat`` computes it: the
    quaternion normalized by sqrt(sum of squares + 1e-12), then the
    matrix's entries, each rounded to float32."""
    q = np.asarray(q, np.float32)
    s = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]
    q = q / np.sqrt(s + np.float32(1e-12))
    w, x, y, z = q
    one, two = np.float32(1), np.float32(2)
    return np.array([
        [one - two * (y * y + z * z), two * (x * y - w * z),
         two * (x * z + w * y)],
        [two * (x * y + w * z), one - two * (x * x + z * z),
         two * (y * z - w * x)],
        [two * (x * z - w * y), two * (y * z + w * x),
         one - two * (x * x + y * y)]], np.float32)


def _pc_frame(pc: Dict[str, np.ndarray]) -> dict:
    pts = np.stack([pc["x"], pc["y"], pc["z"]], -1).astype(np.float32)
    ok = np.isfinite(pts).all(-1)
    frame = {"points": pts[ok], "sensor_ts": float(pc.get("stamp", 0.0))}
    if "point_ts" in pc:
        ts = pc["point_ts"][ok]
        rng = ts.max() - ts.min()
        if rng > 0:
            frame["point_ts"] = ((ts - ts.min()) / rng).astype(np.float32)
    return frame


@register_loader("rosbag")
class RosbagDataset(BaseDataset):
    """ROS1 bag loader (reference dataset/dataloaders/rosbag.py).

    ``data_path``: a .bag file or a directory of split bags;
    ``sequence``: the PointCloud2 topic (auto-detected when unique).
    Frames are indexed scans of that topic, in timestamp order.
    """

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        paths = [data_path] if os.path.isfile(data_path) else sorted(
            glob.glob(os.path.join(data_path, "*.bag")))
        if not paths:
            raise FileNotFoundError(f"no .bag files at {data_path}")
        self._msgs: List[Tuple[int, bytes]] = []
        topic = sequence or None
        pc_topics = set()
        for p in paths:
            bag = Ros1Bag(p)
            for tp, mtype, t_ns, payload in bag.iterate():
                if mtype in _PC2_TYPES:
                    pc_topics.add(tp)
                    if topic is None or tp == topic:
                        self._msgs.append((t_ns, payload))
        if topic is None and len(pc_topics) > 1:
            raise ValueError(
                f"multiple PointCloud2 topics {sorted(pc_topics)}; pass "
                "one as the sequence argument")
        self._msgs.sort(key=lambda m: m[0])

    def __len__(self):
        return len(self._msgs)

    def __getitem__(self, idx):
        _, payload = self._msgs[idx]
        return _pc_frame(decode_ros1_pointcloud2(payload))


@register_loader("mcap")
class McapDataset(BaseDataset):
    """MCAP loader (reference dataset/dataloaders/mcap.py): ROS1- or
    CDR-encoded PointCloud2 messages from one topic."""

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        paths = [data_path] if os.path.isfile(data_path) else sorted(
            glob.glob(os.path.join(data_path, "*.mcap")))
        if not paths:
            raise FileNotFoundError(f"no .mcap files at {data_path}")
        topic = sequence or None
        self._msgs: List[Tuple[int, str, bytes]] = []
        pc_topics = set()
        for p in paths:
            mc = McapFile(p)
            for tp, schema, enc, t_ns, data in mc.iterate():
                if schema in _PC2_TYPES:
                    pc_topics.add(tp)
                    if topic is None or tp == topic:
                        self._msgs.append((t_ns, enc, data))
        if topic is None and len(pc_topics) > 1:
            raise ValueError(
                f"multiple PointCloud2 topics {sorted(pc_topics)}; pass "
                "one as the sequence argument")
        self._msgs.sort(key=lambda m: m[0])

    def __len__(self):
        return len(self._msgs)

    def __getitem__(self, idx):
        _, enc, data = self._msgs[idx]
        pc = (decode_ros1_pointcloud2(data) if enc == "ros1"
              else decode_cdr_pointcloud2(data))
        return _pc_frame(pc)


@register_loader("mcap_ipb_car")
class McapIpbCarDataset(BaseDataset):
    """IPB-Car MCAP recordings (reference mcap_ipb_car.py:1-601):
    multi-topic MCAPs with one LiDAR PointCloud2 topic and ROS1-encoded
    camera Image topics, calibration from a side-car ``calib.json``
    ({cam: {"K": 3x3, "T_c_l": 4x4}})."""

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        paths = [data_path] if os.path.isfile(data_path) else sorted(
            glob.glob(os.path.join(data_path, "*.mcap")))
        if not paths:
            raise FileNotFoundError(f"no .mcap files at {data_path}")
        calib_path = os.path.join(
            os.path.dirname(paths[0]) or ".", "calib.json")
        self.calib = {}
        if os.path.exists(calib_path):
            with open(calib_path) as f:
                self.calib = json.load(f)
        scans: List[Tuple[int, str, bytes]] = []
        images: Dict[str, List[Tuple[int, bytes]]] = {}
        for p in paths:
            mc = McapFile(p)
            for tp, schema, enc, t_ns, data in mc.iterate():
                if schema in _PC2_TYPES and (
                        not sequence or tp == sequence):
                    scans.append((t_ns, enc, data))
                elif schema in _IMG_TYPES and enc == "ros1":
                    images.setdefault(tp.strip("/").replace("/", "_"),
                                      []).append((t_ns, data))
        scans.sort(key=lambda m: m[0])
        self._scans = scans
        self._images = {k: sorted(v) for k, v in images.items()}

    def __len__(self):
        return len(self._scans)

    @property
    def cam_names(self):
        return sorted(self._images)

    def __getitem__(self, idx):
        t_ns, enc, data = self._scans[idx]
        pc = (decode_ros1_pointcloud2(data) if enc == "ros1"
              else decode_cdr_pointcloud2(data))
        frame = _pc_frame(pc)
        imgs, Ks, Ts = {}, {}, {}
        for cam, msgs in self._images.items():
            ts = np.asarray([m[0] for m in msgs])
            j = int(np.argmin(np.abs(ts - t_ns)))
            if abs(int(ts[j]) - t_ns) > 0.2e9:
                continue
            img, _ = decode_ros1_image(msgs[j][1])
            imgs[cam] = img
            cal = self.calib.get(cam, {})
            h, w = img.shape[:2]
            Ks[cam] = np.asarray(cal.get(
                "K", [[w, 0, w / 2], [0, w, h / 2], [0, 0, 1]]), np.float64)
            Ts[cam] = np.asarray(cal.get("T_c_l", np.eye(4)), np.float64)
        if imgs:
            frame.update({"img": imgs, "K": Ks, "T_c_l": Ts})
        return frame


@register_loader("nuscenes")
class NuScenesDataset(BaseDataset):
    """nuScenes from the on-disk schema (reference nuscenes.py:1-405,
    which requires nuscenes-devkit; the schema is plain JSON + binary
    point files so it is read directly).

    ``data_path``: the dataroot containing ``v1.0-*`` and ``samples/``;
    ``sequence``: scene name (e.g. "scene-0061") or index.
    """

    LIDAR = "LIDAR_TOP"

    def __init__(self, data_path: str, sequence: str = "", cfg=None):
        super().__init__(data_path, sequence, cfg)
        vers = sorted(glob.glob(os.path.join(data_path, "v1.0-*")))
        if not vers:
            raise FileNotFoundError(f"no v1.0-* schema dir in {data_path}")
        table_dir = vers[0]

        def tbl(name):
            with open(os.path.join(table_dir, name + ".json")) as f:
                return json.load(f)

        scenes = tbl("scene")
        if sequence:
            match = [s for s in scenes if s["name"] == sequence
                     or s["token"] == sequence]
            if not match and sequence.isdigit():
                match = [scenes[int(sequence)]]
            if not match:
                raise KeyError(f"scene '{sequence}' not found")
            scene = match[0]
        else:
            scene = scenes[0]

        samples = {s["token"]: s for s in tbl("sample")}
        sdata = tbl("sample_data")
        calib = {c["token"]: c for c in tbl("calibrated_sensor")}
        sensors = {s["token"]: s for s in tbl("sensor")}
        ego = {e["token"]: e for e in tbl("ego_pose")}

        # keyframe sample chain
        chain = []
        tok = scene["first_sample_token"]
        while tok:
            chain.append(samples[tok])
            tok = samples[tok]["next"]

        by_sample: Dict[str, Dict[str, dict]] = {}
        for sd in sdata:
            if not sd["is_key_frame"]:
                continue
            cs = calib[sd["calibrated_sensor_token"]]
            channel = sensors[cs["sensor_token"]]["channel"]
            by_sample.setdefault(sd["sample_token"], {})[channel] = sd

        self._frames = []
        for s in chain:
            rec = by_sample.get(s["token"], {})
            if self.LIDAR in rec:
                self._frames.append(rec)
        self._calib = calib
        self._ego = ego

    @staticmethod
    def _pose(rec) -> np.ndarray:
        T = np.eye(4)
        q = np.asarray(rec["rotation"], np.float64)   # w x y z
        T[:3, :3] = _quat_to_rotmat_f32(q)
        T[:3, 3] = rec["translation"]
        return T

    def __len__(self):
        return len(self._frames)

    def gt_poses(self):
        poses = []
        for rec in self._frames:
            sd = rec[self.LIDAR]
            T_w_e = self._pose(self._ego[sd["ego_pose_token"]])
            T_e_l = self._pose(self._calib[sd["calibrated_sensor_token"]])
            poses.append(T_w_e @ T_e_l)
        return poses

    def __getitem__(self, idx):
        rec = self._frames[idx]
        sd = rec[self.LIDAR]
        path = os.path.join(self.data_path, sd["filename"])
        pts = np.fromfile(path, np.float32).reshape(-1, 5)  # x y z i ring
        frame = {"points": pts[:, :3].copy(),
                 "sensor_ts": sd["timestamp"] * 1e-6}
        T_w_l = None
        imgs, Ks, Ts = {}, {}, {}
        T_w_e = self._pose(self._ego[sd["ego_pose_token"]])
        T_e_l = self._pose(self._calib[sd["calibrated_sensor_token"]])
        T_w_l = T_w_e @ T_e_l
        frame["gt_pose"] = T_w_l
        for ch, csd in rec.items():
            if not ch.startswith("CAM_"):
                continue
            img_path = os.path.join(self.data_path, csd["filename"])
            if not os.path.exists(img_path):
                continue
            cs = self._calib[csd["calibrated_sensor_token"]]
            if not cs.get("camera_intrinsic"):
                continue
            imgs[ch] = read_rgb(img_path)
            Ks[ch] = np.asarray(cs["camera_intrinsic"], np.float64)
            T_w_ec = self._pose(self._ego[csd["ego_pose_token"]])
            T_ec_c = self._pose(cs)
            # camera-from-lidar via the world frame
            Ts[ch] = np.linalg.inv(T_w_ec @ T_ec_c) @ T_w_l
        if imgs:
            frame.update({"img": imgs, "K": Ks, "T_c_l": Ts})
        return frame


# the "ouster" loader lives in data/ouster.py (from-scratch
# pcap + LEGACY/RNG19 packet decoding + beam-model XYZ, no vendor SDK)
