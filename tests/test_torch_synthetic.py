"""The port's copy of the synthetic scenes vs the JAX package's (CPU,
numpy on both sides): the same worlds, poses, image, depth and scan,
exactly equal."""

import os
import sys

import numpy as np
import pytest

from pings_tpu.data import synthetic as jsyn
from pings_tpu.utils import pose as hp
from pings_tpu_torch.data import synthetic as tsyn

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_validation_data as mvd  # noqa: E402


def _same_world(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def test_worlds_and_paths_equal():
    _same_world(jsyn.default_world(), tsyn.default_world())
    _same_world(mvd.circuit_world(), tsyn.circuit_world())
    for tex in ("checker", "smooth"):
        _same_world(mvd.room_world(tex), tsyn.room_world(tex))
    pj, yj = mvd.circuit_path(250, step=1.2)
    pt, yt = tsyn.circuit_path(250, step=1.2)
    np.testing.assert_array_equal(pj, pt)
    np.testing.assert_array_equal(yj, yt)
    for s in (0.0, 85.0, 140.0, 230.0, 300.0):
        a, b = mvd._circuit_point(s, 80.0, 15.0), tsyn._circuit_point(
            s, 80.0, 15.0)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    w = np.array([0.1, -0.2, 2.5])
    np.testing.assert_array_equal(hp.so3_exp(w), tsyn.so3_exp(w))
    T = hp.se3_exp(np.array([1.0, 2, 3, 0.1, 0.2, 0.3]))
    np.testing.assert_array_equal(hp.se3_inv(T), tsyn.se3_inv(T))


@pytest.mark.parametrize("i", [0, 115])
def test_kitti_frame_and_scan_equal(i):
    """Frame i of the kitti sequence as make_kitti makes it (its poses,
    camera and LiDAR), against the port's kitti_* functions."""
    objects = mvd.circuit_world()
    pos2d, yaws = mvd.circuit_path(250, step=1.2)
    T = np.eye(4)
    T[:3, :3] = hp.so3_exp(np.array([0, 0, yaws[i]]))
    T[:3, 3] = [pos2d[i, 0], pos2d[i, 1], 1.6]
    np.testing.assert_array_equal(T, tsyn.kitti_poses(250)[i])
    T_c_l, K, W, H = tsyn.kitti_rig()
    W, H = W // 4, H // 4             # a quarter-size image: same rays/4
    K = K.copy()
    K[:2] /= 4
    img_j, depth_j = mvd.render_pinhole(T @ hp.se3_inv(T_c_l), K, W, H,
                                        objects)
    img_t, depth_t = tsyn.render_pinhole(T @ tsyn.se3_inv(T_c_l), K, W, H,
                                         tsyn.circuit_world())
    np.testing.assert_array_equal(img_j, img_t)
    np.testing.assert_array_equal(depth_j, depth_t)
    assert img_t.dtype == np.uint8 and (depth_t > 0).mean() > 0.3
    # the scan, as make_kitti's loop body computes it
    el = np.radians(np.linspace(-24.8, 2.0, 64))
    az = np.linspace(-np.pi, np.pi, 1024, endpoint=False)
    AZ, EL = np.meshgrid(az, el)
    dirs_l = np.stack([np.cos(EL) * np.cos(AZ), np.cos(EL) * np.sin(AZ),
                       np.sin(EL)], -1).reshape(-1, 3)[::8]
    rng = np.random.default_rng(0)
    dirs_w = dirs_l @ T[:3, :3].T
    t, hit, _ = jsyn._ray_scene(np.tile(T[:3, 3], (len(dirs_w), 1)), dirs_w,
                                objects)
    t = t + rng.normal(0, 0.008, len(t)) * hit
    keep = hit & (t < 80.0) & (t > 1.5)
    want = (dirs_l[keep] * t[keep, None]).astype(np.float32)
    np.testing.assert_array_equal(tsyn.kitti_lidar_dirs()[::8], dirs_l)
    got = tsyn.kitti_scan(T, tsyn.circuit_world(), np.random.default_rng(0),
                          dirs_l)
    np.testing.assert_array_equal(want, got)
    assert len(got) > 1000


def test_kitti_frame_sky_and_depth():
    T = tsyn.kitti_poses(3)[2]
    img, depth, sky = tsyn.kitti_frame(T, tsyn.default_world())
    assert img.shape == (240, 640, 3) and depth.shape == sky.shape == (240,
                                                                      640)
    assert ((depth > 0) ^ (sky > 0)).all() and 0 < sky.mean() < 1


def test_project_scan_to_cam_matches(rng):
    from pings_tpu.data.frame import project_scan_to_cam as jproj
    from pings_tpu_torch.data.frame import project_scan_to_cam as tproj

    pts = np.concatenate([rng.uniform(-4, 4, (800, 2)),
                          rng.uniform(0.5, 9, (800, 1))], 1).astype(
        np.float32)
    mask = rng.uniform(size=800) < 0.9
    K = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]])
    T = hp.se3_exp(np.array([0.1, -0.2, 0.3, 0.02, 0.01, -0.03]))
    a = jproj(pts, mask, T, K, 64, 48)
    b = tproj(pts, mask, T, K, 64, 48, "cpu").numpy()
    assert (a > 0).sum() > 100
    np.testing.assert_array_equal(a > 0, b > 0)
    np.testing.assert_allclose(b, a, atol=1e-5)
