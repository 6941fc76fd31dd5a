"""The read-only neural-point query of the port vs the JAX package (CPU).

A map is built by the JAX package's ``insert_points`` and carried across
with ``map_from_jax``. ``voxel_hash`` and the neighbour indices must be
exactly equal; weights and features within 1e-6. Query points on the
corners of a lattice of map points have several neighbours at the same
distance: there the choice falls to the last bit of the squared distance,
which XLA and torch round differently, so for those the distances of the
chosen neighbours are compared (1e-6) and not their indices."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.config import Config as JConfig
from pings_tpu.models import neural_points as jnpm
from pings_tpu.ops import transforms as jtf
from pings_tpu_torch.models import neural_points as tnpm
from pings_tpu_torch.ops import transforms as ttf


def build_maps(rng, n=1500, **over):
    cfg = JConfig.load(overrides=dict(
        max_points=4096, buffer_size=1 << 14, voxel_size_m=0.2,
        feature_dim=8, color_feature_dim=8, **over))
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    # a regular lattice too (off the voxel centres, so that the points
    # equidistant from 8 of it lie inside a voxel, not on a voxel face)
    g = np.stack(np.meshgrid(*[np.arange(-3, 3) * 0.2 + 0.05] * 3,
                             indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([pts, (g + [6.0, 0, 0]).astype(np.float32)])
    n = len(pts)
    m = jnpm.init_map(cfg, jax.random.PRNGKey(0))
    m = jnpm.insert_points(
        m, jnp.asarray(pts), jnp.asarray(rng.uniform(size=(n, 3)).astype(
            np.float32)), jnp.ones(n, bool),
        jnp.tile(jnp.array([1.0, 0, 0, 0]), (n, 1)), jnp.int32(0),
        jnp.zeros(8), jnp.float32(1e9))
    local = np.zeros(m.positions.shape[0], bool)
    local[:int(m.count):2] = True
    m = m.replace(local_mask=jnp.asarray(local), certainty=jnp.asarray(
        rng.uniform(0, 3, local.shape).astype(np.float32)))
    flat = {"map." + f.name: np.array(getattr(m, f.name))
            for f in dataclasses.fields(m)
            if f.name not in ("resolution", "buffer_size")}
    tm = tnpm.map_from_jax(flat, cfg.voxel_size_m, cfg.buffer_size, "cpu")
    return cfg, m, tm


def test_voxel_hash_matches(rng):
    c = rng.integers(-2 ** 20, 2 ** 20, (5000, 3)).astype(np.int32)
    c[:4] = [[0, 0, 0], [-1, -1, -1], [2 ** 30, -2 ** 30, 77],
             [-2 ** 31, 2 ** 31 - 1, 1]]
    for size in (1 << 14, 4194304, 1000003):
        j = np.asarray(jtf.voxel_hash(jnp.asarray(c), size))
        t = ttf.voxel_hash(torch.from_numpy(c), size).numpy()
        np.testing.assert_array_equal(j, t)
        assert t.min() >= 0 and t.max() < size


def test_make_stencil_matches():
    for r, a in ((1, 0.2), (2, 0.2), (2, 1.0)):
        np.testing.assert_array_equal(jnpm.make_stencil(r, a),
                                      tnpm.make_stencil(r, a))


def _queries(rng, m):
    n = int(m.count)
    pos = np.asarray(m.positions[:n])
    q = pos[rng.integers(0, n, 600)] + rng.normal(size=(600, 3)) * 0.08
    corners = np.stack(np.meshgrid(*[np.arange(-2, 3) * 0.2 - 0.05] * 3,
                                   indexing="ij"), -1).reshape(-1, 3)
    far = rng.uniform(20, 30, (20, 3))
    return (np.concatenate([q, far]).astype(np.float32),
            (corners + [6.0, 0, 0]).astype(np.float32))


def _chosen_d2(positions, q, kidx, cap):
    d2 = np.sum((q[:, None] - positions[kidx]) ** 2, -1)
    return np.sort(np.where(kidx >= cap, np.inf, d2), axis=1)


@pytest.mark.parametrize("k,r,local", [(6, 2, False), (6, 1, False),
                                       (4, 2, True)])
def test_query_matches(rng, k, r, local):
    cfg, m, tm = build_maps(rng)
    q, tied = _queries(rng, m)
    jt = jnpm.query_neighbor_idx(m, jnp.asarray(tied), k, r, 0.2, local)
    tt = tnpm.query_neighbor_idx(tm, torch.from_numpy(tied), k, r, 0.2, local)
    pos = np.asarray(m.positions)
    np.testing.assert_allclose(
        _chosen_d2(pos, tied, tt.numpy(), tm.capacity),
        _chosen_d2(pos, tied, np.asarray(jt), tm.capacity), atol=1e-6)
    jk = jnpm.query_neighbor_idx(m, jnp.asarray(q), k, r, 0.2, local)
    tk = tnpm.query_neighbor_idx(tm, torch.from_numpy(q), k, r, 0.2, local)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    assert (tk.numpy() < tm.capacity).any() and (tk.numpy()[-20:]
                                                 == tm.capacity).all()
    jq = jnpm.query_feature(m, jnp.asarray(q), k, r, 0.2, local)
    tq = tnpm.query_feature(tm, torch.from_numpy(q), k, r, 0.2, local)
    np.testing.assert_array_equal(np.asarray(jq.nn_idx), tq.nn_idx.numpy())
    np.testing.assert_array_equal(np.asarray(jq.nn_count),
                                  tq.nn_count.numpy())
    np.testing.assert_array_equal(np.asarray(jq.valid), tq.valid.numpy())
    for f in ("feat", "color_feat", "weights"):
        np.testing.assert_allclose(getattr(tq, f).numpy(),
                                   np.asarray(getattr(jq, f)), atol=1e-6,
                                   rtol=1e-6, err_msg=f)


def test_eval_neighbors_shifted_points_and_gradient(rng):
    """A shared neighbour table evaluated at shifted points, and the
    gradient of the weights and offsets with respect to the points."""
    cfg, m, tm = build_maps(rng)
    q = _queries(rng, m)[0][:400]
    jk = jnpm.query_neighbor_idx(m, jnp.asarray(q), 6, 2, 0.2)
    q2 = (q + rng.normal(size=q.shape) * 0.3).astype(np.float32)
    wsum = rng.normal(size=(400, 6, 11)).astype(np.float32)

    def jf(p):
        r = jnpm.eval_neighbors(m, p, jk, 2, 0.2)
        return jnp.sum(r.feat * wsum) + jnp.sum(r.weights ** 2)

    tp = torch.from_numpy(q2).requires_grad_(True)
    r = tnpm.eval_neighbors(tm, tp, torch.from_numpy(np.array(jk)).long(),
                            2, 0.2)
    val = (r.feat * torch.from_numpy(wsum)).sum() + (r.weights ** 2).sum()
    np.testing.assert_allclose(float(val), float(jf(jnp.asarray(q2))),
                               rtol=1e-5)
    val.backward()
    gj = np.asarray(jax.grad(jf)(jnp.asarray(q2)))
    assert np.isfinite(tp.grad.numpy()).all()
    np.testing.assert_allclose(tp.grad.numpy(), gj, rtol=1e-3,
                               atol=1e-4 * np.abs(gj).max())
