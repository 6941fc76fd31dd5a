"""The port's streaming loaders against the JAX package's (CPU): ``rosbag``
(plain and bz2 chunks, a topic chosen among two), ``mcap`` (CDR and ROS1
messages, with and without a chunk), ``mcap_ipb_car`` (a LiDAR topic and
two ROS1 camera topics, one out of time, with a ``calib.json``) and
``nuscenes`` (two keyframes, rotated ego and sensor poses, a PNG camera
image). Each reads the same files in both packages; every key of every
frame is equal (arrays exact, dtypes equal). nuScenes' rotations are
built in float32 in both packages (the JAX package through ``jnp``, the
port in numpy): the poses are held exactly.

The fixtures are made by the writers of ``tests/test_streaming_loaders.py``
(imported), with a ROS1 ``sensor_msgs/Image`` writer and a multi-channel
MCAP writer added here."""

import bz2
import json
import struct

import numpy as np
import pytest

from pings_tpu.data.base import dataset_factory as jfactory
from pings_tpu_torch.data.base import dataset_factory as tfactory
from pings_tpu_torch.data.imageio import write_png
from test_streaming_loaders import (
    _hdr_fields, _mcap_record, _mcap_string, _record, _ros1_string,
    cdr_pointcloud2, ros1_pointcloud2, write_mcap, write_ros1_bag)
from test_torch_loaders import compare


@pytest.fixture
def clouds(rng):
    return [rng.uniform(-5, 5, (200, 3)).astype(np.float32)
            for _ in range(3)]


def test_rosbag_frames_equal(tmp_path, clouds):
    path = str(tmp_path / "tiny.bag")
    write_ros1_bag(path, clouds)
    t = compare("rosbag", path)
    assert len(t) == 3 and "point_ts" in t[0]
    np.testing.assert_array_equal(t[1]["points"], clouds[1])


def test_rosbag_bz2_chunk_and_topic(tmp_path, clouds):
    """One bz2 chunk with two PointCloud2 topics; the sequence names one."""
    records = b""
    for conn, topic in enumerate((b"/points", b"/other")):
        records += _record(
            _hdr_fields(op=b"\x07", conn=struct.pack("<I", conn),
                        topic=topic),
            _hdr_fields(topic=topic, type=b"sensor_msgs/PointCloud2",
                        md5sum=b"0" * 32, message_definition=b""))
    for i, pts in enumerate(clouds):
        for conn in (0, 1):
            records += _record(
                _hdr_fields(op=b"\x02", conn=struct.pack("<I", conn),
                            time=struct.pack("<II", 10 + i, conn)),
                ros1_pointcloud2(pts * (1 + conn), stamp=(10 + i, 0)))
    path = str(tmp_path / "bz2.bag")
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_record(_hdr_fields(
            op=b"\x05", compression=b"bz2",
            size=struct.pack("<I", len(records))), bz2.compress(records)))
    t = compare("rosbag", path, "/other")
    np.testing.assert_array_equal(t[2]["points"], clouds[2] * 2)
    for pkg in (jfactory, tfactory):
        with pytest.raises(ValueError, match="multiple"):
            pkg("rosbag", path, "")


@pytest.mark.parametrize("encoding", ["cdr", "ros1"])
@pytest.mark.parametrize("in_chunk", [False, True])
def test_mcap_frames_equal(tmp_path, clouds, encoding, in_chunk):
    path = str(tmp_path / "tiny.mcap")
    write_mcap(path, clouds, encoding=encoding, in_chunk=in_chunk)
    t = compare("mcap", path)
    assert len(t) == 3


def ros1_image(img: np.ndarray, stamp, encoding=b"rgb8") -> bytes:
    h, w = img.shape[:2]
    data = np.ascontiguousarray(img).tobytes()
    return (struct.pack("<III", 0, *stamp) + _ros1_string(b"cam")
            + struct.pack("<II", h, w) + _ros1_string(encoding)
            + struct.pack("<BI", 0, len(data) // h) + _ros1_string(data))


def write_mcap_channels(path, channels):
    """channels: [(topic, schema name, message encoding, [(t_ns, bytes)])]"""
    recs = b""
    for cid, (topic, schema, enc, _) in enumerate(channels, start=1):
        recs += _mcap_record(0x03, struct.pack("<H", cid)
                             + _mcap_string(schema) + _mcap_string(b"ros1msg")
                             + struct.pack("<I", 0))
        recs += _mcap_record(0x04, struct.pack("<HH", cid, cid)
                             + _mcap_string(topic) + _mcap_string(enc)
                             + struct.pack("<I", 0))
    for cid, (_, _, _, msgs) in enumerate(channels, start=1):
        for seq, (t_ns, payload) in enumerate(msgs):
            recs += _mcap_record(0x05, struct.pack("<HIQQ", cid, seq, t_ns,
                                                   t_ns) + payload)
    with open(path, "wb") as f:
        f.write(b"\x89MCAP0\r\n")
        f.write(_mcap_record(0x01, _mcap_string(b"") + _mcap_string(b"")))
        f.write(recs)
        f.write(_mcap_record(0x02, struct.pack("<QQI", 0, 0, 0)))
        f.write(b"\x89MCAP0\r\n")


def test_mcap_ipb_car_frames_equal(tmp_path, clouds, rng):
    sec = 10 ** 9
    scans = [(10 * sec + i * sec // 10, cdr_pointcloud2(p))
             for i, p in enumerate(clouds)]
    img = lambda: rng.integers(0, 255, (6, 8, 3), dtype=np.uint8)
    front = [(10 * sec + i * sec // 10 + 1000, ros1_image(img(), (10, i)))
             for i in range(3)]
    # the second camera's only image is 0.25 s after the first scan: it
    # goes with no scan but the second one (0.15 s off)
    rear = [(10 * sec + sec // 4, ros1_image(img()[..., ::-1].copy(), (10, 0),
                                             b"bgr8"))]
    write_mcap_channels(str(tmp_path / "car.mcap"), [
        (b"/os/points", b"sensor_msgs/msg/PointCloud2", b"cdr", scans),
        (b"/cam/front/image", b"sensor_msgs/Image", b"ros1", front),
        (b"/cam/rear/image", b"sensor_msgs/Image", b"ros1", rear)])
    calib = {"cam_front_image": {"K": [[50, 0, 4], [0, 50, 3], [0, 0, 1]],
                                 "T_c_l": np.eye(4).tolist()}}
    (tmp_path / "car.mcap").with_name("calib.json").write_text(
        json.dumps(calib))
    t = compare("mcap_ipb_car", str(tmp_path / "car.mcap"))
    assert t.cam_names == ["cam_front_image", "cam_rear_image"]
    assert sorted(t[0]["img"]) == ["cam_front_image"]
    assert sorted(t[1]["img"]) == ["cam_front_image", "cam_rear_image"]


def _q(axis, ang):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    return [float(np.cos(ang / 2))] + list(np.sin(ang / 2) * axis)


def test_nuscenes_frames_equal(tmp_path, rng):
    root = tmp_path / "nusc"
    (root / "v1.0-mini").mkdir(parents=True)
    (root / "samples" / "LIDAR_TOP").mkdir(parents=True)
    (root / "samples" / "CAM_FRONT").mkdir(parents=True)
    sd, ego = [], []
    for i in range(2):
        rel = f"samples/LIDAR_TOP/scan{i}.pcd.bin"
        rng.uniform(-5, 5, (100, 5)).astype(np.float32).tofile(root / rel)
        cam_rel = f"samples/CAM_FRONT/img{i}.png"
        write_png(str(root / cam_rel),
                  rng.integers(0, 255, (6, 8, 3), dtype=np.uint8))
        ego += [{"token": f"ep{i}", "translation": [10.0 + i, 5.0, 0.1],
                 "rotation": _q([0.1, 0.2, 1.0], 0.3 + 0.2 * i),
                 "timestamp": i},
                {"token": f"epc{i}", "translation": [10.2 + i, 5.0, 0.1],
                 "rotation": _q([0.0, 0.1, 1.0], 0.31 + 0.2 * i),
                 "timestamp": i}]
        sd += [{"token": f"sd{i}", "sample_token": f"sa{i}",
                "ego_pose_token": f"ep{i}", "calibrated_sensor_token": "cs0",
                "filename": rel, "is_key_frame": True,
                "timestamp": 1000000 + 50000 * i},
               {"token": f"sdc{i}", "sample_token": f"sa{i}",
                "ego_pose_token": f"epc{i}",
                "calibrated_sensor_token": "cs1", "filename": cam_rel,
                "is_key_frame": True, "timestamp": 1000000 + 50000 * i}]
    tables = {
        "scene": [{"token": "sc0", "name": "scene-0001",
                   "first_sample_token": "sa0"}],
        "sample": [{"token": "sa0", "next": "sa1", "prev": "",
                    "scene_token": "sc0"},
                   {"token": "sa1", "next": "", "prev": "sa0",
                    "scene_token": "sc0"}],
        "sensor": [{"token": "se0", "channel": "LIDAR_TOP",
                    "modality": "lidar"},
                   {"token": "se1", "channel": "CAM_FRONT",
                    "modality": "camera"}],
        "calibrated_sensor": [
            {"token": "cs0", "sensor_token": "se0",
             "translation": [0.9, 0.0, 1.8],
             "rotation": _q([0.0, 0.0, 1.0], -1.57), "camera_intrinsic": []},
            {"token": "cs1", "sensor_token": "se1",
             "translation": [1.7, 0.0, 1.5],
             "rotation": [0.5, -0.5, 0.5, -0.5],
             "camera_intrinsic": [[1266.4, 0, 816.3], [0, 1266.4, 491.5],
                                  [0, 0, 1]]}],
        "ego_pose": ego,
        "sample_data": sd,
    }
    for name, rows in tables.items():
        with open(root / "v1.0-mini" / f"{name}.json", "w") as f:
            json.dump(rows, f)
    t = compare("nuscenes", str(root), "scene-0001")
    assert len(t) == 2 and t[1]["img"]["CAM_FRONT"].shape == (6, 8, 3)
    R = t.gt_poses()[1][:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)


def test_bag_writer_matches_kitti_loader(tmp_path, rng):
    """scripts/torch_make_bag_data.py: the bag and the MCAP it writes from
    a KITTI sequence's scans read back, in both packages, as the kitti
    loader's scans, with its sweep times up to the bag loader's
    normalization (1e-6) and stamps 10 + 0.1 i s."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    from torch_make_bag_data import make_bags
    from pings_tpu_torch.data.kitti import KittiDataset

    seq = tmp_path / "00"
    (seq / "velodyne").mkdir(parents=True)
    for i in range(3):
        rng.normal(0, 10, (500, 4)).astype(np.float32).tofile(
            str(seq / "velodyne" / f"{i:06d}.bin"))
    bag, mcap = make_bags(str(seq), str(tmp_path / "bags"))
    for name, path in (("rosbag", bag), ("mcap", mcap)):
        t = compare(name, path, "/velodyne_points")
        for i in range(3):
            raw = np.fromfile(str(seq / "velodyne" / f"{i:06d}.bin"),
                              np.float32).reshape(-1, 4)[:, :3]
            np.testing.assert_array_equal(t[i]["points"], raw)
            kt = KittiDataset._azimuth_ts(raw)
            np.testing.assert_allclose(
                t[i]["point_ts"], (kt - kt.min()) / (kt.max() - kt.min()),
                rtol=0, atol=1e-6)
            assert abs(t[i]["sensor_ts"] - (10.0 + 0.1 * i)) < 1e-9
