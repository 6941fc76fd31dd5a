"""The port's loop-closure map operations against the JAX package's (CPU):
``rotmat_to_quat`` on each of its four branches (the trace and each
diagonal largest), ``adjust_map`` and the replay pool's re-posing within
1e-6, and ``recreate_hash`` (the recency rule and the rule around a
reference frame) and ``prune_map`` with the hash table, the valid mask and
the count exactly equal, on a 64-bucket table that forces conflicts and
ties in ``ts_update``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.models import neural_points as jnpm
from pings_tpu.ops import transforms as jtf
from pings_tpu.slam.pipeline import _transform_pool as j_transform_pool
from pings_tpu.utils import pose as hp
from pings_tpu_torch.models import neural_points as tnpm
from pings_tpu_torch.ops import transforms as ttf
from pings_tpu_torch.slam.pipeline import _transform_pool as t_transform_pool
from torch_slam_helpers import (  # noqa: F401
    configs, map_to_torch, one_torch_thread)


def rotations(branch, n=200, seed=0):
    """Rotations whose largest of (trace, m00, m11, m22) is ``branch``:
    small angles (trace), or angles near pi about an axis near x, y or
    z."""
    rng = np.random.default_rng(seed)
    if branch == 0:
        phi = rng.normal(size=(n, 3)) * 0.4
    else:
        axis = rng.normal(size=(n, 3)) * 0.2
        axis[:, branch - 1] = 1.0
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        phi = axis * rng.uniform(2.6, 3.1, (n, 1))
    R = np.stack([hp.so3_exp(p) for p in phi]).astype(np.float32)
    d = np.stack([np.trace(R, axis1=1, axis2=2), R[:, 0, 0], R[:, 1, 1],
                  R[:, 2, 2]], 1)
    assert (d.argmax(1) == branch).all()
    return R


@pytest.mark.parametrize("branch", [0, 1, 2, 3])
def test_rotmat_to_quat_branches(branch):
    R = rotations(branch)
    a = np.asarray(jtf.rotmat_to_quat(jnp.asarray(R)))
    b = ttf.rotmat_to_quat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert (b[:, 0] >= 0).all()


def make_map(seed=0, n=1500, cap=2000, buckets=64, t_max=5):
    """A JAX map of ``n`` points in a 8 m cube, creation and update frames
    in [0, t_max) (so that a bucket holds several points of one frame), a
    tenth of them pruned, and random certainties; and the configs."""
    jcfg, tcfg = configs(max_points=cap, buffer_size=buckets)
    rng = np.random.default_rng(seed)
    m = jnpm.init_map(jcfg, jax.random.PRNGKey(0))
    c = m.capacity
    pos = np.zeros((c + 1, 3), np.float32)
    pos[:n] = rng.uniform(-4, 4, (n, 3))
    q = rng.normal(size=(c + 1, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ts_c = np.zeros(c + 1, np.int32)
    ts_c[:n] = rng.integers(0, t_max, n)
    ts_u = np.zeros(c + 1, np.int32)
    ts_u[:n] = ts_c[:n] + rng.integers(0, 3, n)
    val = np.zeros(c + 1, bool)
    val[:n] = rng.random(n) > 0.1
    cert = np.zeros(c + 1, np.float32)
    cert[:n] = rng.uniform(0, 10, n)
    m = m.replace(positions=jnp.asarray(pos), quats=jnp.asarray(q),
                  ts_create=jnp.asarray(ts_c), ts_update=jnp.asarray(ts_u),
                  valid_mask=jnp.asarray(val), certainty=jnp.asarray(cert),
                  count=jnp.int32(n))
    return m


def jcopy(m):
    return jax.tree.map(jnp.copy, m)


@pytest.mark.parametrize("ref_ts", [None, 0, 2, 7])
def test_recreate_hash_equal(ref_ts):
    m = make_map()
    got = tnpm.recreate_hash(map_to_torch(m), ref_ts).hash_table.numpy()
    want = np.asarray(jnpm.recreate_hash(
        jcopy(m), None if ref_ts is None else jnp.int32(ref_ts)).hash_table)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (64,) and (got >= 0).all()   # every bucket taken


@pytest.mark.parametrize("thre", [2.0, 5.0])
def test_prune_map_equal(thre):
    m = make_map(seed=1)
    t = tnpm.prune_map(map_to_torch(m), thre)
    j = jnpm.prune_map(jcopy(m), jnp.float32(thre))
    np.testing.assert_array_equal(t.valid_mask.numpy(),
                                  np.asarray(j.valid_mask))
    assert int(t.count) == int(j.count)
    assert 0 < int(t.valid_mask.sum()) < int(m.valid_mask.sum())
    np.testing.assert_array_equal(
        tnpm.recreate_hash(t).hash_table.numpy(),
        np.asarray(jnpm.recreate_hash(j).hash_table))


def deltas(n_frames=5, seed=0):
    """Per-frame pose-graph corrections of up to 0.3 m and 3 deg, padded
    with identities to 16 frames."""
    rng = np.random.default_rng(seed)
    D = np.tile(np.eye(4), (16, 1, 1))
    for i in range(n_frames):
        D[i] = hp.se3_exp(np.concatenate([rng.normal(0, 0.15, 3),
                                          rng.normal(0, 0.03, 3)]))
    return D.astype(np.float32)


def test_adjust_map_and_pool_within_1e6():
    m = make_map(seed=2)
    D = deltas()
    t = tnpm.adjust_map(map_to_torch(m), torch.from_numpy(D))
    j = jnpm.adjust_map(jcopy(m), jnp.asarray(D))
    np.testing.assert_allclose(t.positions.numpy(), np.asarray(j.positions),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.quats.numpy(), np.asarray(j.quats),
                               rtol=0, atol=1e-6)
    # the replay pool: samples re-posed by their frame's correction
    from pings_tpu.mapping import pool as jpool
    from pings_tpu_torch.mapping import pool as tpool

    rng = np.random.default_rng(3)
    P = 512
    pts = rng.uniform(-4, 4, (P, 3)).astype(np.float32)
    ts = rng.integers(0, 20, P).astype(np.int32)  # past the padding too
    jp = jpool.init_pool(P).replace(points=jnp.asarray(pts),
                                    ts=jnp.asarray(ts))
    tp = tpool.init_pool(P, device="cpu")
    tp.points.copy_(torch.from_numpy(pts))
    tp.ts.copy_(torch.from_numpy(ts))
    want = np.asarray(j_transform_pool(jp, jnp.asarray(D)).points)
    got = t_transform_pool(tp, torch.from_numpy(D)).points.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
