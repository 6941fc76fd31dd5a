"""The port's mesher (``pings_tpu_torch/slam/mesher.py``), its copy of the
native library and ``field.color_at`` against the JAX package's, on the
committed replica map (68,572 neural points): the grid query's SDF within
1e-5 m and its neighbour counts and trust mask exactly; marching
tetrahedra on one SDF grid with equal output (the same C++ on the same
grid); ``recon_map_mesh`` at 0.2 and 0.1 m with vertex counts within
0.5% and a chamfer distance under 0.02 x the grid resolution (a sign can
flip where the SDF crosses near 0, so meshes are not compared vertex by
vertex); ``color_at`` within 1e-5; and the cluster filter exactly."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pings_tpu import inspect_map as jim
from pings_tpu import native as jnative
from pings_tpu.models import field as jfield
from pings_tpu.slam import mesher as jmesher
from pings_tpu_torch import inspect_map as tim
from pings_tpu_torch import native as tnative
from pings_tpu_torch.eval.mesh import eval_pair
from pings_tpu_torch.models import field as tfield
from pings_tpu_torch.slam import mesher as tmesher
from torch_slam_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RUN = os.path.join(ROOT, "runs_validation", "replica_synth_20260822_050419")


@pytest.fixture(scope="module")
def systems():
    jcfg, jsys = jim.load_system(RUN)
    tcfg, tsys = tim.load_system(RUN, device="cpu")
    return jcfg, jsys, tcfg, tsys


def _aabb_grid(tsys, res):
    pos = tsys.m.positions[:int(tsys.m.count)].numpy()
    lo, hi = pos.min(0) - 0.2, pos.max(0) + 0.2
    dims = tuple(int(np.ceil(e / res)) + 1 for e in hi - lo)
    return lo.astype(np.float64), dims


@pytest.fixture(scope="module")
def grid(systems):
    """The SDF and mask of both packages on the map's box at 0.1 m."""
    jcfg, jsys, tcfg, tsys = systems
    origin, dims = _aabb_grid(tsys, 0.1)
    js, jm = jmesher.Mesher(jcfg).query_sdf_grid(jsys.m, jsys.decoders,
                                                 origin, dims, 0.1)
    ts, tm = tmesher.Mesher(tcfg, "cpu").query_sdf_grid(
        tsys.m, tsys.decoders, origin, dims, 0.1)
    return origin, dims, js, jm, ts, tm


def test_grid_query_matches_jax(systems, grid):
    jcfg, jsys, tcfg, tsys = systems
    origin, dims, js, jm, ts, tm = grid
    assert ts.shape == js.shape == dims and ts.dtype == np.float32
    assert 1000 < tm.sum() < tm.size        # a real edge to the trust mask
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    # the neighbour counts behind the mask, on the first batch of the grid
    xs = origin[0] + np.arange(dims[0]) * 0.1
    ys = origin[1] + np.arange(dims[1]) * 0.1
    zs = origin[2] + np.arange(dims[2]) * 0.1
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)[:65536]
    args = (jcfg.logistic_gaussian_ratio * jcfg.sigma_sigmoid_m,
            jcfg.query_nn_k, jcfg.num_nei_cells, jcfg.search_alpha)
    _, _, _, jn = jmesher._grid_query(jsys.m, jsys.decoders,
                                      jnp.asarray(pts), *args)
    with torch.no_grad():
        _, tn = tmesher._grid_query(tsys.m, tsys.decoders,
                                    torch.as_tensor(pts), *args)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert len(np.unique(tn.numpy())) > 3


@pytest.mark.parametrize("masked", [True, False])
def test_marching_tetrahedra_equal_on_one_grid(grid, masked):
    origin, _, js, jm, _, _ = grid
    mask = jm if masked else None
    jv, jt = jnative.marching_tetrahedra(js, origin, 0.1, mask=mask)
    tv, tt = tnative.marching_tetrahedra(js, origin, 0.1, mask=mask)
    assert len(tv) > 1000
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)


def test_nn_distances_equal(grid):
    origin, _, js, jm, _, _ = grid
    v, _ = tnative.marching_tetrahedra(js, origin, 0.1, mask=jm)
    q = v + np.random.default_rng(0).normal(0, 0.05, v.shape).astype(
        np.float32)
    np.testing.assert_array_equal(tnative.nn_distances(q, v, 0.1),
                                  jnative.nn_distances(q, v, 0.1))


@pytest.mark.parametrize("res", [0.2, 0.1])
def test_recon_map_mesh_matches_jax(systems, res):
    jcfg, jsys, tcfg, tsys = systems
    jv, jt, jc = jmesher.Mesher(jcfg).recon_map_mesh(jsys.m, jsys.decoders,
                                                     res=res)
    tv, tt, tc = tmesher.Mesher(tcfg, "cpu").recon_map_mesh(
        tsys.m, tsys.decoders, res=res)
    assert len(jv) > 0 and abs(len(tv) - len(jv)) <= 0.005 * len(jv)
    assert tc is not None and tc.shape == (len(tv), 3)
    # the vertices lie on the cell edges, at most a cell apart: compared
    # as two clouds, equal meshes are 0 apart
    pair = eval_pair(tv, jv, threshold=res)
    assert pair["chamfer_l1_m"] < 0.02 * res, pair


def test_color_at_matches_jax(systems):
    jcfg, jsys, tcfg, tsys = systems
    n = int(tsys.m.count)
    rng = np.random.default_rng(4)
    pos = tsys.m.positions[:n].numpy()
    pts = (pos[rng.choice(n, 20000)]
           + rng.normal(0, 0.05, (20000, 3))).astype(np.float32)
    kw = dict(k=jcfg.query_nn_k, stencil_r=jcfg.num_nei_cells,
              search_alpha=jcfg.search_alpha)
    jc, jv = jfield.color_at(jsys.m, jsys.decoders, jnp.asarray(pts), **kw)
    with torch.no_grad():
        tc, tv = tfield.color_at(tsys.m, tsys.decoders,
                                 torch.as_tensor(pts), **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0.2 < tv.float().mean() < 1.0
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    # the mesher's vertex colours (0.5 where no neighbour)
    q = pts[:3000]
    np.testing.assert_allclose(
        tmesher.Mesher(tcfg, "cpu").query_colors(tsys.m, tsys.decoders, q),
        jmesher.Mesher(jcfg).query_colors(jsys.m, jsys.decoders, q),
        rtol=0, atol=1e-5)


def test_filter_isolated_clusters_matches_jax(grid):
    origin, _, js, jm, _, _ = grid
    v, t = tnative.marching_tetrahedra(js, origin, 0.1, mask=jm)
    cols = np.random.default_rng(2).random((len(v), 3)).astype(np.float32)
    for min_v in (10, 200):
        a = tmesher.filter_isolated_clusters(v, t, cols, min_v)
        b = jmesher.filter_isolated_clusters(v, t, cols, min_v)
        assert 0 < len(a[0]) < len(v) if min_v == 200 else len(a[0]) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
