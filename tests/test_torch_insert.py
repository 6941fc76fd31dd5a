"""The port's map insertion against the JAX package's (CPU), bit for bit:
``init_map``, and ``insert_points`` over three scans into a small map
whose hash table is small enough for collisions, with a travel threshold
small enough for stale refreshes and a capacity the third scan overflows:
every field, the dump row and the hash table equal. ``accumulate_certainty``
within 1e-6 relative (its scatter-add order is free)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.config import Config as JConfig
from pings_tpu.models import neural_points as jnpm
from pings_tpu_torch.config import Config as TConfig
from pings_tpu_torch.models import neural_points as tnpm
from torch_slam_helpers import map_to_torch, one_torch_thread  # noqa: F401

OVER = dict(max_points=700, buffer_size=512, voxel_size_m=0.3,
            feature_dim=8, color_feature_dim=6)


def _fields(m):
    return [f.name for f in dataclasses.fields(m)
            if f.name not in ("resolution", "buffer_size")]


def _assert_maps_equal(tm, jm):
    for f in _fields(jm):
        np.testing.assert_array_equal(getattr(tm, f).detach().numpy(),
                                      np.asarray(getattr(jm, f)), f)


def test_init_map_equal():
    jcfg, tcfg = JConfig.load(overrides=OVER), TConfig.load(overrides=OVER)
    jm = jnpm.init_map(jcfg)
    tm = tnpm.init_map(tcfg, device="cpu")
    _assert_maps_equal(tm, jm)
    assert (tm.resolution, tm.buffer_size) == (jm.resolution, jm.buffer_size)
    tcfg.feature_std = 0.1
    g = torch.Generator().manual_seed(0)
    tm = tnpm.init_map(tcfg, g, "cpu")
    assert 0.08 < float(tm.geo_feat.std()) < 0.12


def _scans(rng):
    """Three overlapping scans: the second repeats half the first (matches
    and, with the small travel threshold, stale refreshes) and adds
    points 1-2 voxels off existing ones; the third has enough new points
    to overflow the capacity; NaN points and a masked share in each."""
    a = rng.uniform(-3, 3, (400, 3)).astype(np.float32)
    b = np.concatenate([a[:200] + rng.normal(0, 0.01, (200, 3)),
                        a[200:300] + 0.35,
                        rng.uniform(-3, 3, (100, 3))]).astype(np.float32)
    c = rng.uniform(-6, 6, (600, 3)).astype(np.float32)
    out = []
    for p in (a, b, c):
        p = p.copy()
        p[5] = np.nan
        mask = rng.random(len(p)) < 0.9
        rgb = rng.random((len(p), 3)).astype(np.float32)
        q = rng.normal(size=(len(p), 4)).astype(np.float32)
        out.append((p, rgb, mask, q))
    return out


@pytest.mark.parametrize("thre", [1e9, 0.5])
def test_insert_points_bit_exact(rng, thre):
    jcfg, tcfg = JConfig.load(overrides=OVER), TConfig.load(overrides=OVER)
    jm = jnpm.init_map(jcfg)
    tm = tnpm.init_map(tcfg, device="cpu")
    travel = np.array([0.0, 0.3, 1.0, 1.2], np.float32)
    stats = []
    for fid, (p, rgb, mask, q) in enumerate(_scans(rng), start=1):
        count0 = int(jm.count)
        jm = jnpm.insert_points(jm, jnp.asarray(p), jnp.asarray(rgb),
                                jnp.asarray(mask), jnp.asarray(q),
                                jnp.int32(fid), jnp.asarray(travel),
                                jnp.float32(thre))
        out = tnpm.insert_points(tm, torch.from_numpy(p),
                                 torch.from_numpy(rgb),
                                 torch.from_numpy(mask), torch.from_numpy(q),
                                 fid, torch.from_numpy(travel), thre)
        assert out is tm
        _assert_maps_equal(tm, jm)
        stats.append((count0, int(jm.count)))
    ts_u = np.asarray(jm.ts_update)[:int(jm.count)]
    ts_c = np.asarray(jm.ts_create)[:int(jm.count)]
    # the cases happened: collisions (fewer slots than points), refreshed
    # points, and a full map
    assert int(jm.count) == jcfg.max_points, stats
    assert np.sum(np.asarray(jm.hash_table) >= 0) < int(jm.count)
    assert np.any(ts_u > ts_c)


def test_insert_keeps_optimizer_leaves(rng):
    """The feature arrays are written in place: a tensor an optimizer
    holds stays the map's."""
    tcfg = TConfig.load(overrides=OVER)
    tm = tnpm.init_map(tcfg, device="cpu")
    geo = tm.geo_feat.requires_grad_(True)
    p, rgb, mask, q = _scans(rng)[0]
    tnpm.insert_points(tm, torch.from_numpy(p), torch.from_numpy(rgb),
                       torch.from_numpy(mask), torch.from_numpy(q), 0,
                       torch.zeros(4), 1e9)
    assert tm.geo_feat is geo and int(tm.count) > 200


def test_accumulate_certainty(rng):
    jcfg = JConfig.load(overrides=OVER)
    jm = jnpm.init_map(jcfg)
    p, rgb, mask, q = _scans(rng)[0]
    jm = jnpm.insert_points(jm, jnp.asarray(p), jnp.asarray(rgb),
                            jnp.asarray(mask), jnp.asarray(q), jnp.int32(0),
                            jnp.zeros(4), jnp.float32(1e9))
    tm = map_to_torch(jm)
    qp = (p[~np.isnan(p).any(1)] + rng.normal(0, 0.1, (399, 3))).astype(
        np.float32)
    for _ in range(2):
        jq = jnpm.query_feature(jm, jnp.asarray(qp), k=6, stencil_r=1)
        jm = jnpm.accumulate_certainty(jm, jq)
        tq = tnpm.query_feature(tm, torch.from_numpy(qp), k=6, stencil_r=1)
        tm = tnpm.accumulate_certainty(tm, tq)
    want = np.asarray(jm.certainty)
    assert want.max() > 1.0 and want[-1] == 0.0
    np.testing.assert_allclose(tm.certainty.numpy(), want, rtol=1e-6,
                               atol=1e-6 * want.max())
