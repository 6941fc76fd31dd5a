"""The port's folder and pcap loaders against the JAX package's (CPU): each
name reads the same fixture files in both packages, and the datasets give
the same length, camera names and ground truth, and for every frame the
same keys with equal values (arrays exact, dtypes equal).

The fixtures are made as ``tests/test_dataloaders.py`` makes them (its PCD
and PLY writers are imported), with the cameras, timestamps and
calibration files each loader reads added: ``mulran``, ``ncd``, ``nclt``,
``apollo``, ``helipr``, ``kitti360``, ``generic``, ``vbr``, ``r3live``,
``ipb_car`` (both LiDARs), ``oxford``, ``oxford_raw``, ``cka``,
``waymo``, ``agri_slam`` and ``ouster`` (LEGACY and RNG19 packets). PNG
images are written by the port's writer; JPEG images by OpenCV, which the
port's loaders also read them with (it is installed here).
``tests/test_torch_streaming.py`` covers the bags, MCAP and nuScenes."""

import json
import os
import struct

import numpy as np
import pytest

from pings_tpu.data.base import dataset_factory as jfactory
from pings_tpu_torch.data.base import dataset_factory as tfactory
from pings_tpu_torch.data.imageio import write_png
from test_dataloaders import _write_pcd_binary, _write_ply_binary


def assert_same(a, b, where=""):
    """Equal values: dicts key by key, arrays exactly with equal dtypes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (where, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, (
            where, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def compare(name, path, seq=""):
    """Both packages' datasets of ``name`` on the same files; returns the
    port's."""
    j = jfactory(name, path, seq)
    t = tfactory(name, path, seq)
    assert len(t) == len(j) > 0
    assert list(t.cam_names) == list(j.cam_names)
    jg, tg = j.gt_poses(), t.gt_poses()
    assert (jg is None) == (tg is None)
    if jg is not None:
        assert_same([np.asarray(p) for p in tg], [np.asarray(p) for p in jg],
                    "gt")
    for i in range(len(j)):
        assert_same(t[i], j[i], f"{name}[{i}]")
    return t


def _img(rng, h=12, w=16):
    return rng.integers(0, 255, (h, w, 3), dtype=np.uint8)


def _png(path, rng):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, _img(rng))


def _jpg(path, rng):
    import cv2
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, _img(rng)[..., ::-1])


def _iso(n, base="2024-01-01T00:00:00", step=0.1, off=0.0):
    return "".join(f"{base}.{int(round((i * step + off) * 1e9)):09d}\n"
                   for i in range(n))


def _tum(path, stamps):
    with open(path, "w") as f:
        for i, t in enumerate(stamps):
            f.write(f"{t:.9f} {0.3 * i} {0.1 * i} 0 0 0 {0.05 * i} 1\n")


def build_mulran(root, rng):
    d = root / "seq"
    (d / "Ouster").mkdir(parents=True)
    stamps = [1560000000000000000 + i * 100000000 for i in range(3)]
    for t in stamps:
        rng.normal(size=(64 * 16, 4)).astype(np.float32).tofile(
            str(d / "Ouster" / f"{t}.bin"))
    rows = []
    for i, t in enumerate(stamps):
        T = np.eye(4)
        T[:3, 3] = [i * 1.0, 0.2 * i, 0]
        rows.append([t] + list(T[:3, :4].reshape(-1)))
    np.savetxt(str(d / "global_pose.csv"), np.array(rows), delimiter=",")
    return str(d), ""


def build_ncd(root, rng):
    d = root / "quad"
    (d / "raw_format" / "ouster_scan").mkdir(parents=True)
    (d / "ground_truth").mkdir()
    for i in range(2):
        _write_pcd_binary(
            str(d / "raw_format" / "ouster_scan" /
                f"cloud_158383659{i}_18259097{i}.pcd"),
            rng.normal(size=(64 * 16, 3)).astype(np.float32))
    rows = [[1583836590 + i, 182590970 + i, i * 0.1, 0, 0, 0, 0, 0, 1]
            for i in range(2)]
    np.savetxt(str(d / "ground_truth" / "registered_poses.csv"),
               np.array(rows, float), delimiter=",")
    return str(d), ""


def build_nclt(root, rng):
    d = root / "2012-01-08"
    (d / "velodyne_sync").mkdir(parents=True)
    (root / "ground_truth").mkdir()
    stamps = [1326000000000000 + i * 100000 for i in range(3)]
    for t in stamps:
        (rng.normal(size=(40, 4)) * 100).astype(np.int16).tofile(
            str(d / "velodyne_sync" / f"{t}.bin"))
    gt_t = np.linspace(stamps[0] - 10, stamps[-1] + 10, 50)
    gt = np.stack([gt_t] + [np.linspace(0, 1, 50)] * 6, -1)
    np.savetxt(str(root / "ground_truth" / "groundtruth_2012-01-08.csv"),
               gt, delimiter=",")
    return str(d), ""


def build_apollo(root, rng):
    d = root / "seq"
    (d / "pcds").mkdir(parents=True)
    (d / "poses").mkdir()
    for i in range(1, 4):
        _write_pcd_binary(str(d / "pcds" / f"{i}.pcd"),
                          rng.normal(size=(30, 3)).astype(np.float32))
    rows = [[i, i, 0.5 * i, 0.1, 0, 0, 0.1 * i, 0, 1] for i in range(3)]
    np.savetxt(str(d / "poses" / "gt_poses.txt"), np.array(rows, float))
    return str(d), ""


def build_helipr(root, rng):
    (root / "LiDAR" / "Velodyne").mkdir(parents=True)
    (root / "LiDAR_GT").mkdir()
    stamps = [1690000000000000000 + i for i in range(2)]
    for t in stamps:
        with open(str(root / "LiDAR" / "Velodyne" / f"{t}.bin"), "wb") as f:
            for k in range(20):
                f.write(struct.pack("=ffffHf", k * 0.1, k * 0.2, 1.0,
                                    10.0, 3, k * 1e-4))
    with open(str(root / "LiDAR_GT" / "Velodyne_gt.txt"), "w") as f:
        for i, t in enumerate(stamps):
            f.write(f"{t} {i * 0.5} 0 0 0 0 {0.1 * i} 1\n")
    return str(root), "Velodyne"


def build_kitti360(root, rng):
    seq = "2013_05_28_drive_0000_sync"
    lid = root / "data_3d_raw" / seq / "velodyne_points" / "data"
    lid.mkdir(parents=True)
    (root / "calibration").mkdir()
    (root / "data_poses" / seq).mkdir(parents=True)
    for i in range(2):
        rng.normal(size=(50, 4)).astype(np.float32).tofile(
            str(lid / f"{i:010d}.bin"))
        _png(str(root / "data_2d_raw" / seq / "image_00" / "data_rect" /
                 f"{i:010d}.png"), rng)
    with open(str(root / "calibration" / "calib_cam_to_velo.txt"), "w") as f:
        f.write("0 -1 0 0.3  0 0 -1 -0.1  1 0 0 -0.05")
    with open(str(root / "calibration" / "perspective.txt"), "w") as f:
        f.write("P_rect_00: 552.5 0 682.0 0 0 552.5 238.7 0 0 0 1 0\n"
                "R_rect_00: 0.9999 0.0 0.0141 0 1 0 -0.0141 0 0.9999\n")
    with open(str(root / "calibration" / "calib_cam_to_pose.txt"), "w") as f:
        f.write("image_00: 0.037 -0.033 0.998 1.5 -0.999 -0.006 0.037 0.0 "
                "0.005 -0.999 -0.033 0.8\n")
    rows = [[i] + list(np.eye(4)[:3, :4].reshape(-1) + 0.01 * i)
            for i in range(2)]
    np.savetxt(str(root / "data_poses" / seq / "poses.txt"),
               np.array(rows, float))
    return str(root), "0000"


def build_generic(root, rng):
    d = root / "clouds"
    d.mkdir()
    np.save(str(d / "000.npy"), rng.normal(size=(30, 3)).astype(np.float32))
    rng.normal(size=(20, 4)).astype(np.float32).tofile(str(d / "001.bin"))
    xyz = rng.normal(size=(10, 3)).astype(np.float32)
    with open(str(d / "002.ply"), "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 10\nproperty float x\n"
                "property float y\nproperty float z\nproperty uchar red\n"
                "property uchar green\nproperty uchar blue\nend_header\n")
        for p in xyz:
            f.write(f"{p[0]} {p[1]} {p[2]} 200 100 50\n")
    with open(str(d / "003.pcd"), "w") as f:
        f.write("FIELDS x y z\nPOINTS 10\nDATA ascii\n")
        for p in xyz:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
    _write_ply_binary(str(d / "004.ply"), xyz)
    rows = [list((np.eye(4)[:3, :4] + 0.1 * i).reshape(-1)) for i in range(5)]
    np.savetxt(str(d / "poses.txt"), np.array(rows))
    return str(d), ""


def build_vbr(root, rng):
    (root / "ouster_points" / "data").mkdir(parents=True)
    for i in range(2):
        rng.normal(size=(40, 4)).astype(np.float32).tofile(
            str(root / "ouster_points" / "data" / f"{i:06d}.bin"))
        _png(str(root / "camera_left" / "data" / f"{i:06d}.png"), rng)
    (root / "ouster_points" / "timestamps.txt").write_text(_iso(2, off=0.1))
    (root / "camera_left" / "timestamps.txt").write_text(_iso(2, off=0.11))
    (root / "vbr_calib.yaml").write_text(
        "cam_l:\n  intrinsics: [400, 410, 320, 240]\n"
        "  T_b: [[1,0,0,0],[0,1,0,0],[0,0,1,0.2],[0,0,0,1]]\n")
    _tum(str(root / "gt.txt"), [1704067200.1 + 0.1 * i for i in range(3)])
    return str(root), ""


def build_r3live(root, rng):
    (root / "livox_points" / "data").mkdir(parents=True)
    for i in range(2):
        rng.normal(size=(40, 4)).astype(np.float32).tofile(
            str(root / "livox_points" / "data" / f"{i:06d}.bin"))
    for i in range(3):
        _png(str(root / "camera_image_color_compressed" / "data" /
                 f"{i:06d}.png"), rng)
    (root / "livox_points" / "timestamps.txt").write_text(_iso(2))
    (root / "camera_image_color_compressed" / "timestamps.txt").write_text(
        _iso(3, step=0.06))
    return str(root), ""


def build_ipb_car(root, rng):
    for lid in ("lidar_horizontal_points", "lidar_vertical_points"):
        (root / lid / "data").mkdir(parents=True)
        for i in range(2):
            xyz = rng.normal(0, 5, (40, 3)).astype(np.float32)
            xyz[:3] = 0.1                     # the car's own returns
            t = rng.random(40).astype(np.float32)
            _write_ply_t(str(root / lid / "data" / f"{i:06d}.ply"), xyz, t)
    (root / "lidar_horizontal_points" / "timestamps.txt").write_text(_iso(2))
    for cam in ("left", "front"):
        for i in range(2):
            _png(str(root / f"camera_{cam}" / "data" / f"{i:06d}.png"), rng)
        (root / f"camera_{cam}" / "timestamps.txt").write_text(
            _iso(2, off=0.01))
    ext = [[0, -1, 0, 0.1], [0, 0, -1, 0.2], [1, 0, 0, 0.3], [0, 0, 0, 1]]
    calib = {"lidarhorizontalpoints": {"extrinsics": ext},
             "lidarverticalpoints": {"extrinsics": np.eye(4).tolist()},
             "cameraleftimage_raw": {"K": [[300, 0, 8], [0, 300, 6],
                                           [0, 0, 1]], "extrinsics": ext},
             "camerafrontimage_raw": {"K": [[310, 0, 8], [0, 310, 6],
                                            [0, 0, 1]],
                                      "extrinsics": np.eye(4).tolist()}}
    (root / "calibration").mkdir()
    (root / "calibration" / "results.yaml").write_text(json.dumps(calib))
    rows = [list((np.eye(4)[:3, :4] + 0.1 * i).reshape(-1)) for i in range(2)]
    np.savetxt(str(root / "poses_pin_slam.txt"), np.array(rows))
    return str(root), "both_lidars"


def _write_ply_t(path, xyz, t):
    arr = np.zeros(len(xyz), dtype=[("x", "<f4"), ("y", "<f4"),
                                    ("z", "<f4"), ("time", "<f4")])
    arr["x"], arr["y"], arr["z"], arr["time"] = xyz.T[0], xyz.T[1], \
        xyz.T[2], t
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(xyz)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n"
                b"property float time\nend_header\n")
        f.write(arr.tobytes())


def _oxford_tree(base, rng, processed):
    stamps = [(1710000000 + i, 100000000 * i) for i in range(2)]
    if processed:
        clouds = base / "processed" / "vilens-slam" / "undist-clouds"
    else:
        clouds = base / "lidar"
    clouds.mkdir(parents=True)
    for s, ns in stamps:
        _write_pcd_binary(str(clouds / f"cloud_{s}_{ns:09d}.pcd"),
                          rng.normal(size=(30, 3)).astype(np.float32),
                          rng.random(30).astype(np.float32))
    for i in range(2):
        cam = f"cam{i}"
        if processed:
            d = (base / "processed" / "colmap" / "images_rectified" /
                 f"alphasense_driver_ros_{cam}_debayered_image_compressed")
        else:
            d = base / "images" / cam
        for s, ns in stamps:
            _jpg(str(d / f"{s}_{ns + 1000:09d}.jpg"), rng)
    gt = [s + ns * 1e-9 for s, ns in stamps]
    if processed:
        (base / "processed" / "trajectory").mkdir(parents=True)
        _tum(str(base / "processed" / "trajectory" / "gt-tum.txt"), gt)
    else:
        _tum(str(base / "gt-tum.txt"), gt)


def build_oxford(root, rng):
    base = root / "seq"
    _oxford_tree(base, rng, processed=True)
    (root / "calibration").mkdir()
    (root / "calibration" / "cam-lidar-imu.yaml").write_text(
        "cam0:\n  intrinsics: [350, 351, 8, 6]\n"
        "  T_cam_lidar: [[1,0,0,0.1],[0,1,0,0],[0,0,1,0],[0,0,0,1]]\n")
    return str(root), "seq"


def build_oxford_raw(root, rng):
    _oxford_tree(root / "seq", rng, processed=False)
    return str(root), "seq"


def build_cka(root, rng):
    (root / "depth").mkdir(parents=True)
    (root / "poses").mkdir()
    for i in range(2):
        _png(str(root / "color" / f"{i:04d}.png"), rng)
        np.save(str(root / "depth" / f"{i:04d}.npy"),
                rng.uniform(500, 3000, (12, 16)).astype(np.uint16))
        np.savetxt(str(root / "poses" / f"{i:04d}.txt"),
                   np.eye(4) + 0.01 * i)
    (root / "intrinsic.json").write_text(json.dumps(
        {"fx": 20.0, "fy": 21.0, "cx": 8.0, "cy": 6.0,
         "depth_scale": 1000.0}))
    return str(root), ""


def build_waymo(root, rng):
    for name in ("lidar_TOP", "lidar_FRONT"):
        (root / "lidars" / name).mkdir(parents=True)
        for i in range(2):
            _write_pcd_binary(str(root / "lidars" / name / f"{i:03d}.pcd"),
                              rng.normal(size=(25, 3)).astype(np.float32))
    for i in range(2):
        _jpg(str(root / "images_ud" / "cam_FRONT" / f"{i:03d}.jpg"), rng)
    ext = np.eye(4)
    ext[:3, 3] = [1.5, 0, 2.0]
    tf = {"lidar_TOP": {"extrinsic": ext.tolist()},
          "cam_FRONT": {"camera_intrinsic": [[300, 0, 8], [0, 300, 6],
                                             [0, 0, 1]],
                        "extrinsic": np.eye(4).tolist()},
          "gt_poses": [(np.eye(4) + 0.1 * i).tolist() for i in range(2)]}
    (root / "transform.json").write_text(json.dumps(tf))
    return str(root), ""


def build_agri_slam(root, rng):
    (root / "ouster").mkdir(parents=True)
    for i in range(2):
        _write_pcd_binary(str(root / "ouster" / f"{i:04d}.pcd"),
                          rng.normal(size=(25, 3)).astype(np.float32))
        _png(str(root / "camera_left" / f"{i:04d}.png"), rng)
    with open(str(root / "poses.csv"), "w") as f:
        f.write("timestamp,tx,ty,tz,qx,qy,qz,qw\n")
        for i in range(2):
            f.write(f"{i},{0.5 * i},0,0,0,0,{0.1 * i},1\n")
    return str(root), ""


H, W, CPP = 16, 64, 16


def _ouster_meta(profile):
    return {
        "beam_altitude_angles": list(np.linspace(-15, 15, H)),
        "beam_azimuth_angles": list(np.linspace(-1, 1, H)),
        "lidar_origin_to_beam_origin_mm": 12.0,
        "lidar_data_format": {
            "columns_per_frame": W, "pixels_per_column": H,
            "columns_per_packet": CPP, "udp_profile_lidar": profile},
        "lidar_to_sensor_transform":
            [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 36.18, 0, 0, 0, 1],
    }


def _ouster_packet(profile, fid, mid0, rng):
    rngs = rng.integers(2000, 30000, (CPP, H))
    rngs[0, :3] = 0                       # no return
    if profile == "LEGACY":
        out = b""
        for c in range(CPP):
            mid = mid0 + c
            out += struct.pack("<QHHI", 1000 + mid, mid, fid, 0)
            out += b"".join(struct.pack("<IHHHH", int(r), 100, 50, 10, 0)
                            for r in rngs[c])
            out += struct.pack("<I", 0xFFFFFFFF)
        return out
    out = struct.pack("<HH", 3, fid) + b"\0" * 28
    for c in range(CPP):
        mid = mid0 + c
        out += struct.pack("<QHH", 1000 + mid, mid, 1)
        out += b"".join(struct.pack("<IHHHH", int(r), 100, 50, 10, 0)
                        for r in rngs[c])
    return out


def _udp_frame(payload):
    udp = struct.pack(">HHHH", 50000, 7502, 8 + len(payload), 0) + payload
    ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 20 + len(udp), 0, 0, 64, 17,
                     0, b"\x0a\x00\x00\x01", b"\x0a\x00\x00\x02") + udp
    return b"\x00" * 12 + struct.pack(">H", 0x0800) + ip


def build_ouster(root, rng, profile="LEGACY"):
    (root / "os_meta.json").write_text(json.dumps(_ouster_meta(profile)))
    pcap = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
    for fid in range(2):
        for mid0 in range(0, W, CPP):
            fr = _udp_frame(_ouster_packet(profile, fid, mid0, rng))
            pcap += struct.pack("<IIII", 0, 0, len(fr), len(fr)) + fr
    (root / "os_capture.pcap").write_bytes(pcap)
    return str(root / "os_capture.pcap"), ""


NAMES = ["mulran", "ncd", "nclt", "apollo", "helipr", "kitti360", "generic",
         "vbr", "r3live", "ipb_car", "oxford", "oxford_raw", "cka", "waymo",
         "agri_slam"]


@pytest.mark.parametrize("name", NAMES)
def test_loader_frames_equal(tmp_path, rng, name):
    path, seq = globals()[f"build_{name}"](tmp_path, rng)
    t = compare(name, path, seq)
    f = t[0]
    assert f["points"].dtype == np.float32 and len(f["points"]) > 0
    if t.cam_names:
        assert "img" in f and f["img"][t.cam_names[0]].dtype == np.uint8


@pytest.mark.parametrize("profile", ["LEGACY", "RNG19_RFL8_SIG16_NIR16"])
def test_ouster_frames_equal(tmp_path, rng, profile):
    path, seq = build_ouster(tmp_path, rng, profile)
    t = compare("ouster", path, seq)
    # three beams of each packet's first column have no return
    assert len(t) == 2 and len(t[0]["points"]) == H * W - 3 * (W // CPP)


def test_every_jax_loader_is_covered():
    """The names held here and in tests/test_torch_streaming.py are every
    loader the JAX package registers but the ones of earlier slices
    (kitti, kitti_mot, synthetic and the RGB-D loaders, held by
    tests/test_torch_cli.py and tests/test_torch_rgbd.py)."""
    from pings_tpu.data.base import available_loaders
    earlier = {"kitti", "kitti_mot", "synthetic", "replica", "tum", "bonn",
               "azure", "neuralrgbd"}
    streaming = {"rosbag", "mcap", "mcap_ipb_car", "nuscenes"}
    assert set(available_loaders()) - earlier == \
        set(NAMES) | {"ouster"} | streaming
