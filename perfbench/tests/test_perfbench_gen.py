"""The benchmark's frozen generators equal the repository's synthetic
worlds and sensors (``pings_tpu_torch/data/synthetic.py``, the replica
writer's orbit and the replica loader's back-projection) at a small
size, noise left out."""

import importlib.util

import numpy as np
import torch

from conftest import ROOT
from perfbench.gen import sensors, traffic, world as wd
from pings_tpu_torch.data import rgbd, synthetic as syn

CPU = torch.device("cpu")


class _NoNoise:
    def normal(self, loc, scale, size):
        return np.zeros(size)


def _objects_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        # the frozen room has the checker texture alone
        y = {k: v for k, v in y.items()
             if not (k == "texture" and v == "checker")}
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def test_worlds_equal_the_repository_worlds():
    _objects_equal(wd.circuit_world(), syn.circuit_world())
    room = syn.room_world()
    _objects_equal(wd.room_world(), room)
    pos, yaw = wd.circuit_path(40)
    pos_r, yaw_r = syn.circuit_path(40)
    np.testing.assert_array_equal(pos, pos_r)
    np.testing.assert_array_equal(yaw, yaw_r)


def test_poses_equal_the_repository_trajectories():
    for a, b in zip(sensors.kitti_poses(30), syn.kitti_poses(30)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    spec = importlib.util.spec_from_file_location(
        "replica_writer", ROOT / "scripts" / "torch_make_replica_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for i in (0, 7, 33, 59):
        np.testing.assert_allclose(sensors.orbit_pose(i, 60),
                                   mod.replica_pose(i, 60), atol=1e-12)


def test_lidar_scan_equals_kitti_scan_without_noise():
    w = syn.circuit_world()
    T = syn.kitti_poses(5)[4]
    dirs = syn.kitti_lidar_dirs()[::37]
    ref = syn.kitti_scan(T, w, _NoNoise(), dirs_l=dirs)
    got = sensors.lidar_scan(wd.World(w, CPU), T,
                             torch.as_tensor(dirs, dtype=torch.float64),
                             0.0, None, 1.5, 80.0)
    assert got.shape == ref.shape and got.shape[0] > 1000
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_lidar_directions_equal_the_repository_rig():
    np.testing.assert_allclose(sensors.lidar_dirs(64, 1024, -24.8, 2.0),
                               syn.kitti_lidar_dirs(), atol=1e-12)


def test_pinhole_equals_render_pinhole():
    for objs, T in ((syn.circuit_world(),
                     syn.kitti_poses(3)[2] @ syn.se3_inv(syn.kitti_rig()[0])),
                    (syn.room_world(), sensors.orbit_pose(11, 60))):
        K = np.array([[60.0, 0, 39.5], [0, 60.0, 23.5], [0, 0, 1]])
        img_r, depth_r = syn.render_pinhole(T, K, 80, 48, objs)
        img, depth = sensors.pinhole(wd.World(objs, CPU), T, K, 80, 48)
        diff = np.abs(img.numpy().astype(int) - img_r.astype(int)).max(-1)
        # a pixel on a checker's or a wall's edge may take the other side
        # where the ray's float64 sums round the other way
        assert np.mean(diff > 1) < 2e-3
        np.testing.assert_allclose(depth.numpy(), depth_r, atol=1e-5)


def test_backproject_equals_the_replica_loader():
    K = np.array([[60.0, 0, 59.5], [0, 60.0, 33.5], [0, 0, 1]])
    img_r, depth_r = syn.render_pinhole(sensors.orbit_pose(3, 60), K, 120,
                                        68, syn.room_world())
    pts_r, (ys, xs) = rgbd.backproject(depth_r, K, stride=2)
    got = sensors.backproject(torch.as_tensor(depth_r), K,
                              torch.as_tensor(img_r), 2)
    np.testing.assert_allclose(got[:, :3], pts_r, atol=1e-6)
    np.testing.assert_allclose(got[:, 3:], img_r[ys, xs] / 255.0,
                               atol=1e-7)


def test_traffic_is_the_same_for_a_seed_and_moves_with_it():
    from perfbench.harness import common
    cell = common.cell("replica_rgbd.serve")
    seed = 2 ** 31 + 12345
    a = traffic.serve_views(cell["config"], cell["traffic"], seed)
    b = traffic.serve_views(cell["config"], cell["traffic"], seed)
    c = traffic.serve_views(cell["config"], cell["traffic"], seed + 1)
    assert len(a) == len(c) > 60
    np.testing.assert_array_equal(np.stack(a), np.stack(b))
    assert not np.allclose(np.stack(a), np.stack(c))
    # the views stay within the stated offsets of an orbit pose
    orbit = np.stack([sensors.orbit_pose(i, 60)[:3, 3] for i in range(60)])
    d = np.abs(np.stack(a)[:, None, :3, 3] - orbit[None]).max(-1).min(1)
    assert d.max() <= cell["traffic"]["perturb_m"] + 1e-9
