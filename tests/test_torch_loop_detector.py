"""The port's loop detector (``pings_tpu_torch/slam/loop_detector.py``, a
numpy copy) against the JAX package's: scan contexts with and without
features, ring keys, the column-shift distance, the scan-context database
with its virtual side nodes and ring-key prefilter, and the local
(distance-gated) candidate. Same inputs, exactly equal outputs. The clouds
are those of ``tests/test_slam_backend.py:77-130`` and
``tests/test_flag_features.py:121-152``, made from a seed."""

import numpy as np
import pytest

from pings_tpu.config import Config as JConfig
from pings_tpu.slam import loop_detector as jld
from pings_tpu.utils import pose as jhp
from pings_tpu_torch.config import Config as TConfig
from pings_tpu_torch.slam import loop_detector as tld


def walls(rng, n=2000):
    """A few walls and scatter (test_slam_backend.py:94-102)."""
    w1 = np.stack([np.full(n // 4, 8.0), rng.uniform(-10, 10, n // 4),
                   rng.uniform(0, 3, n // 4)], -1)
    w2 = np.stack([rng.uniform(-10, 10, n // 4), np.full(n // 4, -6.0),
                   rng.uniform(0, 2, n // 4)], -1)
    sc = rng.uniform(-1, 1, (n // 2, 3)) * [10, 10, 1.5]
    return np.concatenate([w1, w2, sc]).astype(np.float32)


def ring(rng, n=1500):
    """A ring of fences (test_flag_features.py:111-117)."""
    ang = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(3, 25, n)
    z = rng.uniform(0, 4, n) * (np.sin(3 * ang) > 0)
    return np.stack([r * np.cos(ang), r * np.sin(ang), z],
                    -1).astype(np.float32)


def scatter(rng, n=2000):
    return (rng.uniform(-1, 1, (n, 3)) * [3, 30, 4]).astype(np.float32)


def feats_of(cloud, dim=8):
    return np.tanh(cloud[:, :1] * 0.2 + cloud[:, 1:2] * 0.1
                   + np.arange(dim)[None] * 0.01).astype(np.float32)


def yawed(cloud, deg):
    R = jhp.so3_exp(np.array([0, 0, np.radians(deg)]))
    return (cloud @ R.T).astype(np.float32)


CLOUDS = {"walls": walls, "ring": ring, "scatter": scatter}


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_descriptors_equal(name):
    """scan_context, scan_context_feature and ring_key of both kinds."""
    cloud = CLOUDS[name](np.random.default_rng(3))
    for kw in ({}, {"max_dist": 10.0}, {"num_rings": 8, "num_sectors": 24}):
        a, b = jld.scan_context(cloud, **kw), tld.scan_context(cloud, **kw)
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(tld.ring_key(b), jld.ring_key(a))
        f = feats_of(cloud)
        a = jld.scan_context_feature(cloud, f, **kw)
        b = tld.scan_context_feature(cloud, f, **kw)
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(tld.ring_key(b), jld.ring_key(a))


@pytest.mark.parametrize("pair", ["same_yawed", "other_place", "empty",
                                  "feature_yawed"])
def test_sc_distance_equal(pair):
    rng = np.random.default_rng(5)
    c = walls(rng)
    if pair == "same_yawed":
        x, y = jld.scan_context(c), jld.scan_context(yawed(c, 60))
    elif pair == "other_place":
        x, y = jld.scan_context(c), jld.scan_context(scatter(rng))
    elif pair == "empty":
        x, y = jld.scan_context(c), jld.scan_context(np.zeros((0, 3),
                                                              np.float32))
    else:
        c = ring(rng)
        x = jld.scan_context_feature(c, feats_of(c))
        y = jld.scan_context_feature(yawed(c, 30), feats_of(c))
    assert tld.sc_distance(x, y) == jld.sc_distance(x, y)


@pytest.mark.parametrize("with_feature", [False, True])
def test_scan_context_manager_equal(with_feature):
    """A database of nodes at frames 0, 5, ..., 45 (with the virtual side
    nodes), queried by revisits, other places and recent frames: the same
    nodes, caches and candidates (frame, distance, yaw, side offset)."""
    over = dict(max_range=10.0, loop_with_feature=with_feature)
    jm = jld.ScanContextManager(JConfig.load(overrides=over))
    tm = tld.ScanContextManager(TConfig.load(overrides=over))
    assert tm.with_feature == jm.with_feature == with_feature
    rng = np.random.default_rng(11)
    clouds = [walls(rng) if i % 2 else ring(rng) for i in range(10)]
    feats = [feats_of(c) if with_feature else None for c in clouds]
    for i, (c, f) in enumerate(zip(clouds, feats)):
        jm.add_node(5 * i, c, feats=f)
        tm.add_node(5 * i, c, feats=f)
    for jn, tn in zip(jm.nodes, tm.nodes):
        assert tn.frame_id == jn.frame_id
        np.testing.assert_array_equal(tn.sc, jn.sc)
        np.testing.assert_array_equal(tn.rk, jn.rk)
        np.testing.assert_array_equal(tn.side_offsets, jn.side_offsets)
    queries = [(yawed(clouds[3], 40), feats[3], 100),
               (yawed(clouds[4], -75), feats[4], 100),
               (clouds[9], feats[9], 50),          # its own node is recent
               (scatter(rng), feats_of(scatter(rng)) if with_feature
                else None, 100),
               (clouds[2] + np.float32([0, 2.0, 0]), feats[2], 80)]
    hits = []
    for q, f, fid in queries:
        a = jm.detect_global_loop(q, fid, feats=f)
        b = tm.detect_global_loop(q, fid, feats=f)
        assert b == a
        hits.append(a)
    assert any(h is not None for h in hits)
    np.testing.assert_array_equal(tm._rk_all, jm._rk_all)
    np.testing.assert_array_equal(tm._fid_all, jm._fid_all)


@pytest.mark.parametrize("case", ["return_to_start", "short_travel",
                                  "drift_widens", "first_frame"])
def test_detect_local_loop_equal(case):
    """The distance-gated candidate (test_slam_backend.py:117-127) and
    variants: the same (frame, distance) or None."""
    jc = JConfig.load(overrides=dict(max_range=10.0))
    tc = TConfig.load(overrides=dict(max_range=10.0))
    rng = np.random.default_rng(2)
    poses = [jhp.se3_exp(np.array([i * 1.0, 0, 0, 0, 0, 0]))
             for i in range(50)]
    poses.append(jhp.se3_exp(np.array([0.3, 9.0, 0, 0, 0, 0])))
    travel = [float(i) for i in range(50)] + [100.0]
    drift, idx = 1.0, 50
    if case == "return_to_start":
        poses[-1] = np.eye(4)
    elif case == "short_travel":
        poses, travel, idx = poses[:3], travel[:3], 2
    elif case == "drift_widens":
        drift = 1.5 + rng.uniform()
    else:
        idx = 0
    fids = list(range(len(poses)))
    a = jld.detect_local_loop(poses, fids, travel, idx, drift, jc)
    b = tld.detect_local_loop(poses, fids, travel, idx, drift, tc)
    assert b == a
    if case in ("return_to_start", "drift_widens"):
        assert a is not None
