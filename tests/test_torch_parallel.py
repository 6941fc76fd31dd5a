"""``pings_tpu_torch.parallel`` and the tile offset of the blend against
the JAX package's ``pings_tpu.parallel`` (CPU).

The world is ``tests/test_parallel.py``'s (128x64, 32 tiles, its inputs).
JAX runs on the 8-device CPU mesh that ``tests/conftest.py`` forces, with
the Pallas kernels interpreted where its tests interpret them; the port
runs in gloo groups of 2 and 4 spawned ranks (``torch_parallel_helpers``,
one group per size for the whole module, started before the JAX side is
computed; every rank gets the same inputs and the same deadline, and a
rank that fails or overruns has its group killed and the test fail with
the ranks' errors), and as one process without a group as the
single-device reference.

Tolerances. The port sharded against the port in one process: the JAX
package's own sharded-vs-single bars (``tests/test_parallel.py``: blend
rows 1e-5, transmittance and median depth 1e-6, attr16 gradient 1e-5
absolute and relative; renders 1e-5, 2e-5 rgb and 2e-4 depth). The port
against the JAX package: the blend's cross-package bars
(``tests/test_torch_raster_blend.py``, ``tests/test_torch_blend_bwd.py``:
1e-5 on the rgb, normal and alpha rows and the transmittance, the depth
rows and the median depth by the robust rule (1e-4 on all but 0.2%, 5e-2
on the rest: depth sums reach 10 m, and one pixel of the 3DGS depth row
of this scene is 4.4e-5 apart), the gradient within 2e-4 of its largest
entry: the Pallas kernel sums in bf16-split passes); renders 1e-5
(tile-sharded) and 2e-5 rgb, 2e-4 depth (Gaussian-sharded). Steps: PSNR
within 1e-3 (against JAX) or 1e-4 relative, losses within 1e-4 relative
(against the port's world size 1); gradients within 1e-5 of each leaf's
largest entry (the CPU sums in a fixed order); parameters equal on
every rank bit for bit, and within 5e-6 of the reference where the
gradient is signal (above 1e-3 of its leaf's largest: Adam's eps of
1e-15 turns a gradient near zero into a full step of either sign).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.config import Config as JConfig
from pings_tpu.mapping import gs_mapper as jgm
from pings_tpu.mapping.campool import CamPool as JCamPool
from pings_tpu.models.spawn import gather_local_data
from pings_tpu.ops import raster_pallas as rp
from pings_tpu.ops import rasterize as jrz
from pings_tpu.parallel import mesh as jmesh
from pings_tpu_torch.ops import raster_blend as rb
from pings_tpu_torch.ops import rasterize as trz
from pings_tpu_torch.parallel import distributed as tdist
from pings_tpu_torch.parallel import mesh as tmesh
import torch_parallel_helpers as tph
from test_parallel import H, W, tiny_cfg, world  # noqa: F401 (fixture)

WORLDS = (2, 4)
MODES = ("3dgs", "surfel")
TILE, SUP = 16, 128
NTX, NTY = W // TILE, H // TILE
T0 = NTX * NTY // 2          # the tile slice: the image's second half
# tiny_cfg's overrides (tests/test_parallel.py), for the port's Config
OVERRIDES = dict(
    max_points=4096, buffer_size=1 << 14, voxel_size_m=0.3,
    feature_dim=8, color_feature_dim=8, bs=256,
    geo_mlp_hidden_dim=32, color_mlp_hidden_dim=32,
    gaussian_mlp_hidden_dim=32, pool_capacity=1 << 12,
    spawn_n_gaussian=4, gs_sdf_sample_count=64,
    max_gs_per_tile=128, tile_size=16, max_local_points=1024,
    min_range=0.5, max_range=25.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port in this process, beside JAX's
    pool and the spawned ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blend_inputs(cam, mode):
    """tests/test_parallel.py's tile-sharded blend scene (same draws)."""
    n = 512
    r2 = np.random.default_rng(3)
    means = jnp.asarray(np.stack([
        r2.uniform(-4, 4, n), r2.uniform(-3, 3, n), r2.uniform(2, 9, n)],
        -1), jnp.float32)
    quats = jnp.asarray(r2.normal(size=(n, 4)), jnp.float32)
    quats = quats / jnp.linalg.norm(quats, axis=-1, keepdims=True)
    scales = jnp.asarray(r2.uniform(0.05, 0.2, (n, 3)), jnp.float32)
    if mode == "surfel":
        scales = scales.at[:, 2].set(1e-7)
    opas = jnp.asarray(r2.uniform(0.3, 0.9, n), jnp.float32)
    cols = jnp.asarray(r2.random((n, 3)), jnp.float32)
    valid = jnp.ones(n, bool)
    if mode == "surfel":
        ps = jrz.project_surfels(means, quats, scales, opas, cols, valid,
                                 jnp.eye(4), cam.K, W, H, mode="surfel")
        base = jax.tree.map(jax.lax.stop_gradient, ps.base)
        attr16 = rp.surfel_attr_matrix(ps, cam.K)
    else:
        p = jrz.project_gaussians(means, quats, scales, opas, cols, valid,
                                  jnp.eye(4), cam.K, W, H)
        base = jax.tree.map(jax.lax.stop_gradient, p)
        attr16 = rp.gauss_attr_matrix(p)
    bins = jrz.bin_gaussians(base, W, H, tile=TILE, max_per_tile=128)
    T = NTX * NTY
    return dict(attr16=np.asarray(attr16),
                gauss_tbl=np.asarray(bins.gauss_tbl),
                mask=np.asarray(bins.mask), counts=np.asarray(bins.counts),
                n_overflow=np.asarray(bins.n_overflow),
                wo=r2.random((T, 8, TILE * TILE)).astype(np.float32),
                wt=r2.random((T, 1, TILE * TILE)).astype(np.float32))


def _flat_map(m):
    return {"map." + f.name: np.array(getattr(m, f.name))
            for f in dataclasses.fields(m)
            if f.name not in ("resolution", "buffer_size")}


def _flat_dec(decoders):
    leaves = jax.tree_util.tree_flatten_with_path(decoders)[0]
    return {"dec" + jax.tree_util.keystr(kp): np.asarray(x)
            for kp, x in leaves}


@pytest.fixture(scope="module")
def payload(world):
    """Every input of the port's side, as numpy."""
    cfg, m, decoders, cam, _ = world
    assert cfg == JConfig.load(overrides=OVERRIDES) == tiny_cfg()
    r1 = np.random.default_rng(1)
    n = 1024
    gauss = dict(
        means=np.stack([r1.uniform(-4, 4, n), r1.uniform(-3, 3, n),
                        r1.uniform(2, 9, n)], -1).astype(np.float32),
        quats=np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
        scales=np.full((n, 3), 0.1, np.float32),
        opas=np.full((n,), 0.7, np.float32),
        cols=r1.random((n, 3)).astype(np.float32), valid=np.ones(n, bool))
    local = gather_local_data(m, m.valid_mask, 1024)
    rng = np.random.default_rng(7)     # tests/test_parallel.py's _run_dp
    n_cams = 8
    dp = dict(rgb=rng.random((n_cams, H, W, 3)).astype(np.float32))
    dp["sdf_batch"] = (
        (rng.random((cfg.bs, 3)) * 8).astype(np.float32),
        np.zeros(cfg.bs, np.float32), np.zeros((cfg.bs, 3), np.float32),
        np.ones(cfg.bs, np.float32), np.ones(cfg.bs, bool))
    n_slots = JCamPool(cfg).init_param_pools()[0].a.shape[0]
    dp["cam_slots"] = np.arange(n_cams, dtype=np.int32) % n_slots
    return dict(
        overrides=OVERRIDES, map=_flat_map(m), decoders=_flat_dec(decoders),
        K=np.asarray(cam.K), cam_rgb=np.asarray(cam.rgb),
        cam_depth=np.asarray(cam.depth),
        blend={mode: _blend_inputs(cam, mode) for mode in MODES},
        gauss=gauss,
        local={k: np.asarray(v) for k, v in local._asdict().items()},
        spawn_kwargs=dict(spawn_k=cfg.spawn_n_gaussian,
                          voxel_size=cfg.voxel_size_m,
                          max_range=cfg.max_range),
        local_idx=np.asarray(jnp.nonzero(
            m.valid_mask, size=cfg.max_local_points,
            fill_value=m.capacity)[0]),
        dp=dp)


@pytest.fixture(scope="module", autouse=True)
def groups(payload):
    """The port's ranks: one group per size in WORLDS, started before any
    test of the module runs; ``groups(n)`` joins group n once and returns
    its ranks' results."""
    started = {n: tph.RankGroup(tph.port_cases, n, (payload,))
               for n in WORLDS}
    joined = {}

    def get(n):
        if n not in joined:
            joined[n] = started[n].join()
        return joined[n]

    yield get
    for n, g in started.items():
        if n not in joined:
            g.kill()


@pytest.fixture(scope="module")
def single(payload):
    """The port in one process without a process group: the reference of
    the sharded runs (the same case functions)."""
    mesh = tmesh.make_mesh(device="cpu")
    _, _, dec, cam = tph.build_state(payload)
    return dict(
        blend={mode: tph.case_blend(mesh, payload, mode) for mode in MODES},
        render_sharded=tph.case_render_sharded(mesh, payload),
        gauss_render=tph.case_gauss_render(mesh, payload, dec, cam),
        odd_tiles=tph.case_odd_tiles(mesh, payload),
        gauss_step=tph.case_gauss_step(mesh, payload),
        dp_step=tph.case_dp_step(mesh, payload))


def _port_bins(b, rows=slice(None)):
    return trz.TileBins(*(torch.tensor(b[k][rows]) for k in (
        "gauss_tbl", "mask", "counts")), torch.tensor(b["n_overflow"]))


def _close_blend(mode, got, want):
    """The cross-package bars of the forward blend on (T, 8, P) rows."""
    out, trans, med = (np.asarray(x) for x in got)
    jo, jt, jm = (np.asarray(x) for x in want)
    tight = [0, 1, 2, 3, 4, 5, 7] if mode == "surfel" else [0, 1, 2, 4, 5,
                                                             6, 7]
    np.testing.assert_allclose(out[:, tight], jo[:, tight], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(trans, jt, atol=1e-5, rtol=0)
    depth = 6 if mode == "surfel" else 3
    for a, b in ((out[:, depth], jo[:, depth]), (med, jm)):
        d = np.abs(a - b)
        assert (d > 1e-4).mean() <= 2e-3 and d.max() <= 5e-2, d.max()


def _close_grad(got, want, tol=2e-4):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("mode", MODES)
def test_tile_offset_plain_kernels_match_jax(payload, mode, monkeypatch):
    """blend_fwd_ref / blend_bwd_ref on the second half of the tiles with
    tile0 = 16 against JAX's _blend_gaussians on the same slice with its
    tile0 (interpreted), forward and backward; the port's slice equals
    the same rows of its whole-table blend bit for bit."""
    monkeypatch.setattr(rp, "INTERPRET", True)
    b = payload["blend"][mode]
    rows = slice(T0, None)
    jbins = jrz.TileBins(*(jnp.asarray(b[k][rows] if k != "n_overflow"
                                       else b[k])
                           for k in ("gauss_tbl", "mask", "counts",
                                     "n_overflow")))
    wo, wt = b["wo"][rows], b["wt"][rows]

    def jloss(a16):
        o, t, _ = rp._blend_gaussians(a16, jbins, jnp.array([T0]), NTX, NTY,
                                      TILE, SUP, mode, False)
        return jnp.sum(o * wo) + jnp.sum(t * wt), (o, t, _)

    a16 = jnp.asarray(b["attr16"])
    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(a16)

    tb = _port_bins(b, rows)
    ta = torch.tensor(b["attr16"]).requires_grad_(True)
    out = rb.BlendGaussians.apply(ta, tb, NTX, NTY, TILE, mode, SUP, T0)
    ((out[0] * torch.from_numpy(wo)).sum()
     + (out[1] * torch.from_numpy(wt)).sum()).backward()
    _close_blend(mode, [x.detach() for x in out], jout)
    _close_grad(ta.grad.numpy(), np.asarray(jgrad))
    assert float(np.abs(np.asarray(jgrad)).max()) > 0, "zero gradient"

    # the slice is the whole table's rows, bit for bit; the backward's
    # per-slot rows of the slice are the whole table's too
    whole = rb.blend_fwd_ref(ta.detach(), _port_bins(b), NTX, NTY, TILE,
                             mode, SUP)
    for a, w in zip(out, whole):
        assert torch.equal(a.detach(), w[rows])
    g = [torch.from_numpy(x) for x in (b["wo"], b["wt"])]
    rho = (g[0] * whole[0]).sum(1, keepdim=True)
    tab_all = rb.blend_bwd_ref(ta.detach(), _port_bins(b), g[0], g[1], rho,
                               whole[1], NTX, NTY, TILE, mode, SUP)
    tab = rb.blend_bwd_ref(ta.detach(), tb, g[0][rows], g[1][rows],
                           rho[rows], whole[1][rows], NTX, NTY, TILE, mode,
                           SUP, T0)
    assert torch.equal(tab, tab_all[rows])


@pytest.mark.parametrize("mode", MODES)
def test_tile_sharded_blend_matches(payload, groups, single, mode,
                                    monkeypatch):
    """blend_gaussians_tile_sharded at 2 and 4 ranks: forward and the
    summed attr16 gradient equal the one-process blend (and on every
    rank), and JAX's tile-sharded blend on its 8-device mesh."""
    monkeypatch.setattr(rp, "INTERPRET", True)
    b = payload["blend"][mode]
    jbins = jrz.TileBins(*(jnp.asarray(b[k]) for k in (
        "gauss_tbl", "mask", "counts", "n_overflow")))
    mesh = jmesh.make_mesh(8, axis="tile")

    def jloss(a16):
        o, t, m_ = rp.blend_gaussians_tile_sharded(
            mesh, "tile", a16, jbins, W, H, tile=TILE, superblock=SUP,
            mode=mode)
        return jnp.sum(o * b["wo"]) + jnp.sum(t * b["wt"]), (o, t, m_)

    with mesh:
        (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            jnp.asarray(b["attr16"]))
    ref = single["blend"][mode]
    for n in WORLDS:
        ranks = [r["blend"][mode] for r in groups(n)]
        for got in ranks:
            np.testing.assert_allclose(got["out"], ref["out"], atol=1e-5)
            np.testing.assert_allclose(got["trans"], ref["trans"],
                                       atol=1e-6)
            np.testing.assert_allclose(got["med"], ref["med"], atol=1e-6)
            np.testing.assert_allclose(got["grad"], ref["grad"], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_array_equal(got["grad"], ranks[0]["grad"])
        _close_blend(mode, (ranks[0]["out"], ranks[0]["trans"],
                            ranks[0]["med"]), jout)
        _close_grad(ranks[0]["grad"], np.asarray(jgrad))
    assert float(np.abs(ref["out"]).max()) > 0, "degenerate scene"


def test_render_sharded_matches_jax(world, payload, groups, single):
    """render_sharded (3DGS, kernel route: 32 tiles divide 2 and 4)
    against JAX's on its 8-device mesh and against one process."""
    cfg, m, decoders, cam, _ = world
    g = payload["gauss"]
    mesh = jmesh.make_mesh(8)
    jout = jmesh.render_sharded(
        mesh, *(jnp.asarray(g[k]) for k in ("means", "quats", "scales",
                                            "opas", "cols", "valid")),
        jnp.eye(4), cam.K, W, H, max_per_tile=128)
    for n in WORLDS:
        for r in groups(n):
            got = r["render_sharded"]
            for f in ("rgb", "alpha"):
                np.testing.assert_allclose(got[f], np.asarray(
                    getattr(jout, f)), atol=1e-5, err_msg=f"{n} ranks {f}")
                np.testing.assert_allclose(got[f], single[
                    "render_sharded"][f], atol=1e-5)
    assert float(single["render_sharded"]["alpha"].mean()) > 0.05


def test_gauss_sharded_render_matches_jax(world, payload, groups, single):
    """render_gauss_sharded against JAX's on its 8-device mesh and
    against one process: rgb within 2e-5, depth within 2e-4."""
    cfg, m, decoders, cam, _ = world
    mesh = jmesh.make_mesh(8)
    local = gather_local_data(m, m.valid_mask, 1024)
    fn = jax.jit(lambda lo, de, ca: jmesh.render_gauss_sharded(
        mesh, lo, de, ca, W, H, spawn_kwargs=payload["spawn_kwargs"],
        max_per_tile=128))
    with mesh:
        jout = fn(local, decoders, cam)
    for n in WORLDS:
        for r in groups(n):
            got = r["gauss_render"]
            for want in (dict(rgb=np.asarray(jout.rgb),
                              depth=np.asarray(jout.depth)),
                         single["gauss_render"]):
                np.testing.assert_allclose(got["rgb"], want["rgb"],
                                           atol=2e-5)
                np.testing.assert_allclose(got["depth"], want["depth"],
                                           atol=2e-4)
    assert float(single["gauss_render"]["alpha"].mean()) > 0.05


def test_odd_tile_count_blends_unequal_shares_with_the_kernels(
        world, payload, groups, single):
    """At 112x48 (21 tiles, which divide neither 2 nor 4) both renders
    still take the fused blend (its plain versions here) on every rank,
    in shares of unequal size: the tile-sharded render against JAX's on
    its 8-device mesh (JAX's XLA blend_tiles there), and both renders and
    the Gaussian-sharded render's gradients (window features, two decoder
    weights) against one process, at the bars above (gradients 1e-5 of
    their largest entry)."""
    cfg, m, decoders, cam, _ = world
    g = payload["gauss"]
    jout = jmesh.render_sharded(
        jmesh.make_mesh(8), *(jnp.asarray(g[k]) for k in (
            "means", "quats", "scales", "opas", "cols", "valid")),
        jnp.eye(4), cam.K, tph.ODD_W, tph.ODD_H, max_per_tile=128)
    ref = single["odd_tiles"]
    assert float(ref["rs_alpha"].mean()) > 0.05
    assert all(float(np.abs(x).max()) > 0 for x in ref["grads"])
    for n in WORLDS:
        for r in groups(n):
            got = r["odd_tiles"]
            for f in ("rgb", "alpha"):
                for want in (np.asarray(getattr(jout, f)), ref["rs_" + f]):
                    np.testing.assert_allclose(got["rs_" + f], want,
                                               atol=1e-5)
            np.testing.assert_allclose(got["rgb"], ref["rgb"], atol=2e-5)
            np.testing.assert_allclose(got["depth"], ref["depth"], atol=2e-4)
            _grads_close(got["grads"], ref["grads"])


@pytest.mark.parametrize("n_tiles,nd,want", [
    (32, 4, [(0, 8), (8, 8), (16, 8), (24, 8)]),
    (21, 4, [(0, 6), (6, 5), (11, 5), (16, 5)]),
    (3225, 2, [(0, 1613), (1613, 1612)]),
    (4, 4, [(0, 1), (1, 1), (2, 1), (3, 1)]),
])
def test_tile_shares(n_tiles, nd, want):
    """Contiguous shares that cover every tile once, one tile apart at
    most; fewer tiles than ranks is refused."""
    assert tmesh.tile_shares(n_tiles, nd) == want
    with pytest.raises(ValueError):
        tmesh.tile_shares(nd - 1, nd)


def _signal_close(params, grads, want, atol=5e-6, frac=1e-3):
    """Parameters within ``atol`` of ``want`` where the gradient is above
    ``frac`` of its leaf's largest entry."""
    n_held = 0
    for i, (p, g, w) in enumerate(zip(params, grads, want)):
        if g is None or not np.abs(g).max() > 0:
            continue
        sig = np.abs(g) > frac * np.abs(g).max()
        np.testing.assert_allclose(p[sig], np.asarray(w)[sig], atol=atol,
                                   err_msg=f"leaf {i}")
        n_held += int(sig.sum())
    assert n_held > 100


def _ranks_equal(ranks, case):
    for r in ranks[1:]:
        for a, b in zip(r[case]["params"], ranks[0][case]["params"]):
            np.testing.assert_array_equal(a, b)


def _grads_close(grads, want, tol=1e-5):
    for i, (g, w) in enumerate(zip(grads, want)):
        if w is None:
            assert g is None or not np.abs(g).max() > 0
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, atol=tol * scale, rtol=0,
                                   err_msg=f"leaf {i}")


def test_gauss_sharded_train_step_matches_jax(world, payload, groups,
                                              single):
    """make_gauss_sharded_train_step at 2 and 4 ranks against JAX's
    8-device step (PSNR, parameters where the gradient is signal) and
    against one process (gradients); parameters equal on every rank."""
    cfg, m, decoders, cam, _ = world
    cpool = JCamPool(cfg)
    exposure, cam_delta = cpool.init_param_pools()
    opt = jgm.make_gs_optimizer(cfg)
    local_idx = jnp.asarray(payload["local_idx"])
    mesh = jmesh.make_mesh(8)
    step = jmesh.make_gauss_sharded_train_step(cfg, opt, mesh, W, H,
                                               cfg.max_local_points)
    params = jax.tree.map(jnp.copy, jgm.gs_params(m, decoders, exposure,
                                                  cam_delta))
    with mesh:
        params, _, jpsnr = step(params, opt.init(params), m, decoders,
                                local_idx, cam)
    jleaves = _jax_leaves(params)
    ref = single["gauss_step"]
    for n in WORLDS:
        ranks = groups(n)
        _ranks_equal(ranks, "gauss_step")
        got = ranks[0]["gauss_step"]
        assert np.isfinite(got["psnr"])
        assert abs(got["psnr"] - float(jpsnr)) < 1e-3 * max(
            1.0, abs(float(jpsnr)))
        _grads_close(got["grads"], ref["grads"])
        _signal_close(got["params"], got["grads"], jleaves)
        _signal_close(got["params"], got["grads"], ref["params"])


def _jax_leaves(params):
    """A JAX GS params tree's leaves in the port's param_leaves order."""
    out = []
    for key in jgm.gs_param_labels():
        v = params[key]
        if isinstance(v, dict):
            out += list(v["w"]) + [b for b in v["b"] if b is not None]
        elif isinstance(v, tuple):
            out += list(v)
        else:
            out.append(v)
    return [np.asarray(x) for x in out]


def test_dp_step_matches_world_size_1(groups, single):
    """make_dp_train_step at 2 and 4 ranks against world size 1 on the
    same 8-camera batch: every metric, the all-reduced gradients, and the
    parameters where the gradient is signal; parameters equal on every
    rank."""
    ref = single["dp_step"]
    assert np.isfinite(ref["metrics"]["psnr"])
    assert not ref["metrics"]["nonfinite"]
    for n in WORLDS:
        ranks = groups(n)
        _ranks_equal(ranks, "dp_step")
        got = ranks[0]["dp_step"]
        for k, v in ref["metrics"].items():
            assert abs(got["metrics"][k] - v) <= 1e-4 * max(abs(v), 1e-6), \
                (n, k, got["metrics"][k], v)
        _grads_close(got["grads"], ref["grads"])
        _signal_close(got["params"], got["grads"], ref["params"])


@pytest.mark.slow
def test_dp_step_matches_jax(world, single, monkeypatch):
    """The port's DP step at world size 1 against JAX's on its 8-device
    mesh (tests/test_parallel.py's _run_dp) with the Pallas kernels
    interpreted (on the CPU JAX would take its XLA blend, which has no
    contributions in surfel mode): PSNR within 1e-4 relative, parameters
    where the gradient is signal."""
    from pings_tpu.models import renderer as jrd
    from test_parallel import _run_dp

    monkeypatch.setattr(rp, "INTERPRET", True)
    monkeypatch.setattr(jrd, "_use_pallas", lambda: True)
    jparams, jpsnr = _run_dp(world, 8)
    ref = single["dp_step"]
    assert abs(ref["metrics"]["psnr"] - jpsnr) <= 1e-4 * abs(jpsnr)
    _signal_close(ref["params"], ref["grads"], _jax_leaves(jparams),
                  atol=3e-6)


def test_init_distributed_and_runtime_info(groups, monkeypatch):
    """init_distributed: False without a coordinator; from the PINGS_*
    environment (and idempotent); torchrun's variables where those are
    unset. runtime_info's six keys, in one process and on every rank."""
    for k in ("PINGS_COORDINATOR", "PINGS_NUM_PROCESSES", "PINGS_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.init_distributed(device="cpu") is False
    info = tdist.runtime_info()
    assert info["process_count"] == 1 and info["backend"] == "none"
    envs = (dict(PINGS_COORDINATOR=f"localhost:{tph.free_port()}",
                 PINGS_NUM_PROCESSES="1", PINGS_PROCESS_ID="0"),
            dict(MASTER_ADDR="localhost", MASTER_PORT=str(tph.free_port()),
                 WORLD_SIZE="1", RANK="0"))
    for env in envs:
        with monkeypatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            try:
                assert tdist.init_distributed(device="cpu") is False
                assert torch.distributed.is_initialized()
                assert torch.distributed.get_backend() == "gloo"
                assert tdist.init_distributed(device="cpu") is False
                info = tdist.runtime_info()
                assert info["process_count"] == 1
                assert info["backend"] == "gloo"
                mesh = tmesh.make_mesh(device="cpu")
                assert (mesh.size, mesh.rank) == (1, 0)
            finally:
                torch.distributed.destroy_process_group()
    assert set(info) == {"process_index", "process_count",
                         "local_device_count", "global_device_count",
                         "backend", "device_kind"}
    for n in WORLDS:
        for rank, r in enumerate(groups(n)):
            assert r["mesh"] == (n, rank)
            assert r["first"] == (1, 0 if rank == 0 else -1)
            assert r["info"]["process_index"] == rank
            assert r["info"]["process_count"] == n
            assert r["info"]["global_device_count"] == n
            assert r["info"]["backend"] == "gloo"
