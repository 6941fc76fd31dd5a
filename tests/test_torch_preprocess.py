"""The port's frame preprocessing against the JAX package's (CPU), bit for
bit: ``voxel_down_sample_mask`` (with exact distance ties and masked
points), ``crop_range_mask``, ``preprocess_frame`` (masks, source points
and intensities), ``colorize_scan``, ``pad_pow2``; and the port's copy of
the synthetic dataset and of the host pose helpers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.config import Config as JConfig
from pings_tpu.data import frame as jfr
from pings_tpu.data.base import dataset_factory
from pings_tpu.ops import transforms as jtf
from pings_tpu.utils import pose as hp
from pings_tpu_torch.config import Config as TConfig
from pings_tpu_torch.data import frame as tfr
from pings_tpu_torch.data.synthetic import SyntheticDataset
from pings_tpu_torch.ops import transforms as ttf
from pings_tpu_torch.utils import pose as tp
from torch_slam_helpers import one_torch_thread  # noqa: F401


def test_voxel_down_sample_mask_ties_and_masks(rng):
    v = 0.25
    pts = rng.normal(0, 4, (6000, 3)).astype(np.float32)
    # exact ties: pairs mirrored about their voxel's centre (the lower
    # index must win), a triple at the same distance, duplicates
    c = (np.floor(pts[:300] / v) + 0.5) * v
    pts[300:600] = (2 * c - pts[:300]).astype(np.float32)
    pts[600:603] = pts[603:606] = np.array([[0.125, 0.125, 0.05]] * 3,
                                           np.float32)
    pts[1000:1100] = pts[1100:1200]
    mask = rng.random(6000) < 0.85
    mask[:300] = rng.random(300) < 0.5       # some tie winners masked out
    for size in (v, 0.1, 0.5):
        for tsize in (1 << 20, 1 << 8):       # small table: collisions
            want = np.asarray(jtf.voxel_down_sample_mask(
                jnp.asarray(pts), jnp.asarray(mask), size, tsize))
            got = ttf.voxel_down_sample_mask(
                torch.from_numpy(pts), torch.from_numpy(mask), size,
                tsize).numpy()
            np.testing.assert_array_equal(got, want)
            assert not got[~mask].any()


def test_crop_range_mask(rng):
    pts = rng.normal(0, 20, (20000, 3)).astype(np.float32)
    pts[:50] = pts[:50] / np.linalg.norm(pts[:50], axis=1, keepdims=True)
    for args in ((1.6, 60.0, -3.0, 1e9), (0.5, 25.0, -5.0, 3.0)):
        want = np.asarray(jtf.crop_range_mask(jnp.asarray(pts), *args))
        got = ttf.crop_range_mask(torch.from_numpy(pts), *args).numpy()
        np.testing.assert_array_equal(got, want)


def test_pad_pow2(rng):
    for n in (0, 1, 4096, 4097, 70000):
        a = rng.normal(size=(n, 3)).astype(np.float32)
        for ms in (1024, 4096):
            for x, y in zip(jfr.pad_pow2(a, ms), tfr.pad_pow2(a, ms)):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("over", [
    {}, {"vox_down_m": 0.12, "source_vox_down_m": 0.5, "min_range": 1.6,
         "max_range": 60.0, "min_z": -3.0, "source_max_count": 1000}])
def test_preprocess_frame(over):
    base = dict(min_range=0.5, max_range=25.0, min_z=-5.0, vox_down_m=0.1,
                source_vox_down_m=0.4)
    base.update(over)
    jcfg, tcfg = JConfig.load(overrides=base), TConfig.load(overrides=base)
    frame = dataset_factory("synthetic", "", "3:circle", jcfg)[2]
    # a coloured scan: the photometric intensity has values
    pts = frame["points"]
    col = np.abs(np.sin(pts[:, :3])).astype(np.float32)
    col[::3] = 0.0
    frame = dict(frame, points=np.concatenate([pts, col], 1))
    a = jfr.preprocess_frame(frame, jcfg, np.eye(4), False)
    b = tfr.preprocess_frame(frame, tcfg, np.eye(4), False, "cpu")
    for k in ("points_l", "colors", "mask", "source_points", "source_mask",
              "source_intensity", "gt_pose"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), k)
    assert 0 < b.mask.sum() < len(b.mask)
    assert a.cams.keys() == b.cams.keys()
    for cam in a.cams:
        for k in a.cams[cam]:
            np.testing.assert_array_equal(np.asarray(b.cams[cam][k]),
                                          np.asarray(a.cams[cam][k]))


def test_preprocess_unported_options_raise():
    """Random downsampling and deskewing, which raised before they were
    ported, now run and give the JAX package's frame: the random mask bit
    for bit, the deskewed points within 1e-5 m (tests/test_torch_deskew.py
    holds them in detail)."""
    over = dict(rand_downsample=True, rand_down_r=0.5)
    frame = SyntheticDataset(sequence="1:line")[0]
    a = jfr.preprocess_frame(frame, JConfig.load(overrides=over), np.eye(4),
                             False)
    b = tfr.preprocess_frame(frame, TConfig.load(overrides=over), np.eye(4),
                             False, "cpu")
    np.testing.assert_array_equal(b.mask, a.mask)
    assert 0 < b.mask.sum() < 0.6 * len(b.mask)
    frame = dict(frame, point_ts=np.linspace(0, 1, len(frame["points"]),
                                             dtype=np.float32))
    T_rel = np.eye(4)
    T_rel[:3, :3] = hp.so3_exp(np.array([0.0, 0.0, 0.05]))
    T_rel[:3, 3] = [0.8, 0.1, 0.0]
    a = jfr.preprocess_frame(frame, JConfig(), T_rel, True)
    b = tfr.preprocess_frame(frame, TConfig(), T_rel, True, "cpu")
    np.testing.assert_allclose(b.points_l, a.points_l, rtol=0, atol=1e-5)
    n = len(frame["points"])
    assert np.abs(b.points_l[:n] - frame["points"][:, :3]).max() > 0.5


def test_colorize_scan(rng):
    ds = SyntheticDataset(sequence="2:line")
    f = ds[1]
    T = f["gt_pose"]
    pts_w = (f["points"] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    mask = rng.random(len(pts_w)) < 0.9
    T_c_w = ds.T_c_l @ hp.se3_inv(T)
    want = jfr.colorize_scan(pts_w, mask, T_c_w, ds.K, f["img"]["cam"])
    got = [a.numpy() for a in tfr.colorize_scan(
        pts_w, mask, T_c_w, ds.K, f["img"]["cam"], "cpu")]
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    assert got[1].mean() > 0.1


def test_synthetic_dataset_equals_jax():
    jds = dataset_factory("synthetic", "", "3:circle", None)
    tds = SyntheticDataset(sequence="3:circle")
    assert len(jds) == len(tds) and tds.cam_names == jds.cam_names
    for g, h in zip(jds.gt_poses(), tds.gt_poses()):
        np.testing.assert_array_equal(g, h)
    for i in range(3):
        a, b = jds[i], tds[i]
        assert a.keys() == b.keys()
        for k in a:
            x, y = a[k], b[k]
            if isinstance(x, dict):
                for c in x:
                    np.testing.assert_array_equal(y[c], x[c])
            else:
                np.testing.assert_array_equal(y, x)
    line = SyntheticDataset(sequence="2:line")
    np.testing.assert_array_equal(
        line.gt_poses()[1],
        dataset_factory("synthetic", "", "2:line", None).gt_poses()[1])


def test_pose_helpers_equal_jax(rng):
    for _ in range(20):
        xi = rng.normal(0, 1, 6)
        T0, T1 = hp.se3_exp(xi), hp.se3_exp(rng.normal(0, 1, 6))
        np.testing.assert_array_equal(tp.se3_exp(xi), hp.se3_exp(xi))
        np.testing.assert_array_equal(tp.so3_exp(xi[3:]), hp.so3_exp(xi[3:]))
        np.testing.assert_array_equal(tp.se3_inv(T0), hp.se3_inv(T0))
        np.testing.assert_array_equal(tp.so3_log(T0[:3, :3]),
                                      hp.so3_log(T0[:3, :3]))
        np.testing.assert_array_equal(tp.se3_log(T0), hp.se3_log(T0))
        assert tp.rotation_angle_deg(T0[:3, :3]) == \
            hp.rotation_angle_deg(T0[:3, :3])
        np.testing.assert_array_equal(tp.slerp_pose(T0, T1, 1.3),
                                      hp.slerp_pose(T0, T1, 1.3))
    R = hp.so3_exp(np.array([0.0, 0.0, np.pi - 1e-8]))
    np.testing.assert_array_equal(tp.so3_log(R), hp.so3_log(R))
