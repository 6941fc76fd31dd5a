"""The port's motion compensation and random downsampling against the JAX
package's (CPU): ``quat_slerp`` (both branches, the short-arc flip) and
``slerp_pose`` within 1e-6, ``deskew_points`` within 1e-5 m (points at
the end of the sweep, frac 0, unchanged within 1e-6), the per-sensor time
normalization of a two-LiDAR frame, and ``preprocess_frame`` with
deskewing: points within 1e-5 m, the two voxel masks equal except in cells
that hold a point within 1e-5 m of a voxel face in either package's
coordinates (counted and printed); with random downsampling the mask bit
for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.config import Config as JConfig
from pings_tpu.data import frame as jfr
from pings_tpu.ops import transforms as jtf
from pings_tpu.utils import pose as hp
from pings_tpu_torch.config import Config as TConfig
from pings_tpu_torch.data import frame as tfr
from pings_tpu_torch.data.synthetic import SyntheticDataset
from pings_tpu_torch.ops import transforms as ttf
from torch_slam_helpers import one_torch_thread  # noqa: F401

FACE_TOL = 1e-5


def _pose(rng, ang=0.08, tr=1.0):
    T = np.eye(4)
    T[:3, :3] = hp.so3_exp(rng.normal(0, ang, 3))
    T[:3, 3] = rng.normal(0, tr, 3)
    return T


def _unit(q):
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("case", ["generic", "short_arc", "near", "ends"])
def test_quat_slerp(rng, case):
    n = 512
    q0 = _unit(rng.normal(size=(n, 4)))
    q1 = _unit(rng.normal(size=(n, 4)))
    t = rng.random(n).astype(np.float32)
    if case == "short_arc":         # every dot product negative
        d = np.sum(q0 * q1, -1)
        q1 = np.where(d[:, None] > 0, -q1, q1)
    elif case == "near":            # sin(theta) below 1e-7 and just above
        q1 = q0.copy()
        q1[n // 2:] = _unit(q0[n // 2:] + 1e-4 * rng.normal(size=(n // 2, 4)))
    elif case == "ends":
        t[: n // 3] = 0.0
        t[n // 3: 2 * n // 3] = 1.0
        t[2 * n // 3:] = rng.uniform(0, 1e-6, n - 2 * n // 3)
    want = np.asarray(jtf.quat_slerp(jnp.asarray(q0), jnp.asarray(q1),
                                     jnp.asarray(t)))
    got = ttf.quat_slerp(torch.from_numpy(q0), torch.from_numpy(q1),
                         torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if case == "ends":
        sign = np.where(np.sum(q0 * q1, -1, keepdims=True) < 0, -1, 1)
        np.testing.assert_allclose(got[: n // 3], q0[: n // 3], atol=1e-6)
        np.testing.assert_allclose(got[n // 3: 2 * n // 3],
                                   (sign * q1)[n // 3: 2 * n // 3], atol=1e-6)


def test_slerp_pose(rng):
    T0 = np.stack([_pose(rng, 0.5, 3.0) for _ in range(64)]).astype(np.float32)
    T1 = np.stack([_pose(rng, 0.5, 3.0) for _ in range(64)]).astype(np.float32)
    t = rng.uniform(-0.2, 1.2, 64).astype(np.float32)
    want = np.asarray(jtf.slerp_pose(jnp.asarray(T0), jnp.asarray(T1),
                                     jnp.asarray(t)))
    got = ttf.slerp_pose(torch.from_numpy(T0), torch.from_numpy(T1),
                         torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # one pair with a scalar fraction, as the pipeline's camera offset uses
    want = np.asarray(jtf.slerp_pose(jnp.asarray(T0[0]), jnp.asarray(T1[0]),
                                     0.25))
    got = ttf.slerp_pose(torch.from_numpy(T0[0]), torch.from_numpy(T1[0]),
                         0.25).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("motion", ["turn", "identity_rotation"])
def test_deskew_points(rng, motion):
    n = 65536
    pts = rng.normal(0, 20, (n, 3)).astype(np.float32)
    ts = rng.random(n).astype(np.float32)
    ts[:1000] = 1.0                    # the end of the sweep: frac 0
    T = _pose(rng, 0.06, 1.0)
    if motion == "identity_rotation":  # the near-parallel branch of slerp
        T[:3, :3] = np.eye(3)
    T32 = T.astype(np.float32)
    want, wfrac = (np.asarray(a) for a in jtf.deskew_points(
        jnp.asarray(pts), jnp.asarray(ts), jnp.asarray(T32)))
    got, gfrac = (a.numpy() for a in ttf.deskew_points(
        torch.from_numpy(pts), torch.from_numpy(ts), torch.from_numpy(T32)))
    np.testing.assert_array_equal(gfrac, wfrac)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:1000], pts[:1000], rtol=0, atol=1e-6)
    # the start of the sweep moves by the whole relative motion
    p0 = pts[ts == ts.min()][0]
    np.testing.assert_allclose(got[ts == ts.min()][0],
                               T[:3, :3] @ p0 + T[:3, 3], atol=1e-3)


def _face_cells(pts_a, pts_b, v):
    """The cells (of either package's coordinates) that hold a point
    within FACE_TOL of a face of the voxel grid at ``v`` in either."""
    near = np.zeros(len(pts_a), bool)
    cells = set()
    for p in (pts_a, pts_b):
        r = p / np.float32(v)
        near |= np.any(np.abs(r - np.round(r)) * v < FACE_TOL, axis=-1)
    for p in (pts_a, pts_b):
        cells |= set(map(tuple, np.floor(p[near] / np.float32(v)).astype(
            np.int64)))
    return cells


def _masks_equal_but_faces(a, b, mask_a, mask_b, v):
    """Masks equal except in cells with a point on a voxel face; returns
    the number of such exceptions."""
    diff = np.nonzero(mask_a != mask_b)[0]
    if len(diff) == 0:
        return 0
    cells = _face_cells(a, b, v)
    for i in diff:
        ca = tuple(np.floor(a[i] / np.float32(v)).astype(np.int64))
        cb = tuple(np.floor(b[i] / np.float32(v)).astype(np.int64))
        assert ca in cells or cb in cells, (i, a[i], b[i])
    return len(diff)


def _scan_frame(rng, n=60000):
    """A synthetic scan with per-point times along its azimuth, plus
    points placed exactly on the faces of the 0.1 m voxel grid."""
    f = SyntheticDataset(sequence="1:line")[0]
    pts = np.concatenate([f["points"][:, :3],
                          rng.normal(0, 12, (n, 3)).astype(np.float32)])
    pts[-500:] = (np.round(pts[-500:] / 0.1) * 0.1).astype(np.float32)
    az = np.arctan2(pts[:, 1], pts[:, 0])
    ts = (0.5 * (az / np.pi + 1.0)).astype(np.float32)
    return {"points": pts, "point_ts": ts}


def test_preprocess_frame_deskew(rng):
    frame = _scan_frame(rng)
    T_rel = _pose(rng, 0.05, 1.2)
    jc, tc = JConfig(), TConfig()
    a = jfr.preprocess_frame(frame, jc, T_rel, True)
    b = tfr.preprocess_frame(frame, tc, T_rel, True, "cpu")
    np.testing.assert_allclose(b.points_l, a.points_l, rtol=0, atol=1e-5)
    n_map = _masks_equal_but_faces(a.points_l, b.points_l, a.mask, b.mask,
                                   jc.vox_down_m)
    print(f"deskewed map mask: {n_map} exceptions on voxel faces of "
          f"{int(a.mask.sum())} points kept")
    assert n_map <= 0.001 * a.mask.sum()
    # the tracker's source points, from the source-voxel mask (equal on
    # this scan: no exception there)
    np.testing.assert_allclose(b.source_points, a.source_points, rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(b.source_mask, a.source_mask)
    np.testing.assert_array_equal(b.point_ts, a.point_ts)
    # without deskewing the points are the scan's own
    c = tfr.preprocess_frame(frame, tc, T_rel, False, "cpu")
    np.testing.assert_array_equal(c.points_l[:len(frame["points"])],
                                  frame["points"])


def test_preprocess_frame_multi_lidar_times(rng):
    """Two sensors on their own clocks (times 10-11 s and 0.2-0.7 s):
    each sensor's times are normalized to [0, 1] before the deskew."""
    n = 8000
    pts = rng.normal(0, 10, (n, 3)).astype(np.float32)
    idx = (np.arange(n) >= n // 2).astype(np.int32)
    ts = np.where(idx == 0, 10.0 + rng.random(n),
                  0.2 + 0.5 * rng.random(n)).astype(np.float32)
    frame = {"points": pts, "point_ts": ts, "point_lidar_idx": idx}
    T_rel = _pose(rng, 0.05, 1.0)
    a = jfr.preprocess_frame(frame, JConfig(), T_rel, True)
    b = tfr.preprocess_frame(frame, TConfig(), T_rel, True, "cpu")
    np.testing.assert_allclose(b.points_l, a.points_l, rtol=0, atol=1e-5)
    n_exc = _masks_equal_but_faces(a.points_l, b.points_l, a.mask, b.mask,
                                   JConfig().vox_down_m)
    assert n_exc <= 5
    # the latest point of each sensor stays where it was measured
    for s in (0, 1):
        last = np.nonzero(idx == s)[0][np.argmax(ts[idx == s])]
        np.testing.assert_allclose(b.points_l[last], pts[last], atol=1e-6)


@pytest.mark.parametrize("r,seed", [(0.5, 42), (0.2, 7), (1.0, 3)])
def test_random_downsample_bit_exact(r, seed):
    over = dict(rand_downsample=True, rand_down_r=r, seed=seed)
    frame = SyntheticDataset(sequence="2:line")[1]
    T_rel = np.eye(4)
    T_rel[:3, 3] = [0.5, 0, 0]
    f = dict(frame, point_ts=np.linspace(0, 1, len(frame["points"]),
                                         dtype=np.float32))
    cropped = tfr.preprocess_frame(f, TConfig.load(overrides=dict(
        over, rand_down_r=1.0)), T_rel, False, "cpu").mask.sum()
    for deskew in (False, True):
        a = jfr.preprocess_frame(f, JConfig.load(overrides=over), T_rel,
                                 deskew)
        b = tfr.preprocess_frame(f, TConfig.load(overrides=over), T_rel,
                                 deskew, "cpu")
        np.testing.assert_array_equal(b.mask, a.mask)
        assert abs(b.mask.sum() / cropped - r) < 0.05


def test_skewed_scan_deskews_onto_the_frame():
    """scripts/torch_make_kitti_data.py --skew: a scan cast from the pose at
    each column's sweep time, deskewed with this frame's motion back to
    the previous pose, lies on the geometry seen from this frame's pose:
    median nearest-neighbour distance to the scan re-cast at that pose
    along the same directions under 1 cm off the ground (the 8 mm range
    noise), where the skewed scan is off by more."""
    import os
    import sys
    from scipy.spatial import cKDTree

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    from torch_make_kitti_data import GROUND_Z, skewed_scan
    from pings_tpu_torch.data.kitti import KittiDataset
    from pings_tpu_torch.data.synthetic import (
        _ray_scene, circuit_world, kitti_poses)

    world, poses = circuit_world(), kitti_poses(40)
    i = 35                              # full speed: 1.2 m a frame
    pts, z = skewed_scan(poses[i - 1], poses[i], world,
                         np.random.default_rng(i))
    ts = KittiDataset._azimuth_ts(pts)
    back = (np.linalg.inv(poses[i]) @ poses[i - 1]).astype(np.float32)
    out = ttf.deskew(torch.from_numpy(pts), torch.from_numpy(ts),
                     torch.from_numpy(back)).numpy()
    off = z >= GROUND_Z

    def dist(p):
        d = p / np.linalg.norm(p, axis=1, keepdims=True)
        t, hit, _ = _ray_scene(np.tile(poses[i][:3, 3], (len(d), 1)),
                               d @ poses[i][:3, :3].T, world)
        ref = d * np.where(hit, t, 1e3)[:, None]
        return cKDTree(ref).query(p)[0][off]

    assert np.median(dist(out)) < 0.01
    assert np.median(dist(pts)) > 0.05
