"""The training slice as a whole: ``make_gsdf_step`` of the port against
the JAX package, from carried-over state (CPU).

Set-up of ``tests/test_gs_mapping.py``: a coloured sphere ray-cast into a
64x48 camera, its points inserted into a neural point map, a replay pool
filled by the sampler; map, decoders, GS parameters, optimizer state and
pool are carried into the port with ``map_from_jax``, ``decoders_from_jax``,
``gs_state_from_jax`` and ``pool_from_jax``. The JAX package is run through
its Pallas kernels in interpret mode (on the CPU it would otherwise take
the XLA arbiter, which has no contributions in surfel mode and reuses no
tile table); the port runs the kernels' plain versions.

Tolerances. One step: every loss within 1e-4 relative (1e-6 absolute),
PSNR within 1e-3 dB; gradients within 2e-3 of each leaf's largest entry
(the blend's 256-pixel sums and the MLP matmuls run in another order);
parameters after the step within 2e-2 of the step size lr (Adam divides by
sqrt(nu): a gradient entry near zero can flip the sign of its whole first
step) on all entries, and within 1e-3 of it on 99%. Ten steps: the total
loss within 2e-3 relative at every step, and PSNR rises in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.config import Config as JConfig
from pings_tpu.mapping import gs_mapper as jgm
from pings_tpu.mapping import pool as jrp
from pings_tpu.mapping.campool import CamPool as JCamPool
from pings_tpu.mapping.sampler import sample_rays as jsample_rays
from pings_tpu.models import decoder as jdec
from pings_tpu.models import neural_points as jnpm
from pings_tpu.models import renderer as jrd
from pings_tpu.ops import raster_pallas as rp
from pings_tpu_torch.config import Config as TConfig
from pings_tpu_torch.mapping import gs_mapper as tgm
from pings_tpu_torch.mapping import pool as trp
from pings_tpu_torch.models import decoder as tdec
from pings_tpu_torch.models import neural_points as tnpm
from pings_tpu_torch.models import renderer as trd
from test_gs_mapping import CENTER, RADIUS, sphere_color
from torch_slam_helpers import one_torch_thread  # noqa: F401

W, H = 64, 48
KMAT = np.array([[56.0, 0, 32], [0, 56.0, 24], [0, 0, 1]], np.float32)
L = 512
OVERRIDES = dict(
    max_points=4096, buffer_size=1 << 14, voxel_size_m=0.2, feature_dim=8,
    color_feature_dim=8, bs=256, bs_new_sample=64, geo_mlp_hidden_dim=16,
    color_mlp_hidden_dim=16, gaussian_mlp_hidden_dim=16,
    pool_capacity=1 << 13, lr=0.02, lr_mlp_base=2e-3, spawn_n_gaussian=2,
    gs_sdf_sample_count=64, max_gs_per_tile=64, tile_size=16,
    gradient_decimation=10, sky_on=False, max_range=20.0,
    raster_precision="high", gs_contribution_threshold=0.05,
    weight_decay=1e-4)


@pytest.fixture(autouse=True)
def _pallas_interpreted(monkeypatch):
    monkeypatch.setattr(rp, "INTERPRET", True)
    monkeypatch.setattr(jrd, "_use_pallas", lambda: True)


def _raycast():
    ys, xs = np.mgrid[0:H, 0:W]
    d = np.stack([(xs + 0.5 - KMAT[0, 2]) / KMAT[0, 0],
                  (ys + 0.5 - KMAT[1, 2]) / KMAT[1, 1],
                  np.ones_like(xs, np.float32)], -1)
    dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
    b = dn @ (-CENTER)
    disc = b * b - (CENTER @ CENTER - RADIUS ** 2)
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit = (disc > 0) & (t > 0.1)
    pts = dn * t[..., None]
    rgb = np.where(hit[..., None], sphere_color(pts), 0.0).astype(np.float32)
    depth = np.where(hit, t * dn[..., 2], 0.0).astype(np.float32)
    return rgb, depth, pts[hit].astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _flat_dec(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"dec" + jax.tree_util.keystr(kp): np.asarray(x)
            for kp, x in leaves}


def _optax_state(state):
    """Per-key mu and nu and per-label step counts of the optax
    multi_transform state, as numpy."""
    labels = jgm.gs_param_labels()
    mu, nu, counts = {}, {}, {}
    for key, label in labels.items():
        adam = state.inner_states[label][0][0]
        mu[key], nu[key] = _np_tree(adam.mu[key]), _np_tree(adam.nu[key])
        counts[label] = int(adam.count)
    return mu, nu, counts


def _setup(gs_type, **extra):
    rng = np.random.default_rng(7)
    over = dict(OVERRIDES, gs_type=gs_type, **extra)
    jcfg = JConfig.load(overrides=over)
    tcfg = TConfig.load(overrides=over)
    rgb, depth, pts = _raycast()
    scan = pts[rng.choice(len(pts), size=min(1200, len(pts)), replace=False)]
    scan_rgb = sphere_color(scan).astype(np.float32)
    n = len(scan)
    m = jnpm.init_map(jcfg, jax.random.PRNGKey(3))
    m = jnpm.insert_points(
        m, jnp.asarray(scan), jnp.asarray(scan_rgb), jnp.ones(n, bool),
        jnp.tile(jnp.array([1.0, 0, 0, 0]), (n, 1)), jnp.int32(0),
        jnp.zeros(8), jnp.float32(1e9))
    assert int(m.count) > 100
    # certainty and a varied rgb so that every input of the step is live
    m = m.replace(certainty=jnp.asarray(
        rng.uniform(0, 3, m.certainty.shape).astype(np.float32)))
    decoders = jdec.init_decoders(jax.random.PRNGKey(0), jcfg)
    pool = jrp.init_pool(jcfg.pool_capacity)
    s = jsample_rays(jax.random.PRNGKey(1), jnp.asarray(scan),
                     jnp.asarray(scan_rgb), jnp.ones(n, bool), jnp.zeros(3))
    pool = jrp.pool_insert(pool, s, jnp.int32(0), jax.random.PRNGKey(2))
    jcam = jrd.CamView(K=jnp.asarray(KMAT), T_c_w=jnp.eye(4),
                       rgb=jnp.asarray(rgb), depth=jnp.asarray(depth),
                       sky=jnp.zeros((H, W)), frame_id=jnp.int32(0))
    cpool = JCamPool(jcfg)
    exposure, cam_delta = cpool.init_param_pools()
    slot = cpool.add_keyframe(jcam, np.zeros(3), 0)
    local_idx = jnp.nonzero(m.valid_mask, size=L, fill_value=m.capacity)[0]
    opt = jgm.make_gs_optimizer(jcfg)
    params = jgm.gs_params(m, decoders, exposure, cam_delta)
    state = opt.init(params)
    jstep = jgm.make_gsdf_step(jcfg, opt, W, H, L)

    # the port's side, carried across as numpy
    flat = {"map." + f.name: np.array(getattr(m, f.name))
            for f in dataclasses.fields(m)
            if f.name not in ("resolution", "buffer_size")}
    tm = tnpm.map_from_jax(flat, jcfg.voxel_size_m, jcfg.buffer_size, "cpu")
    td = tdec.decoders_from_jax(_flat_dec(decoders), "cpu")
    mu, nu, counts = _optax_state(state)
    tm, td, tparams, topt = tgm.gs_state_from_jax(
        tcfg, tm, td, _np_tree(params), mu, nu, counts, device="cpu")
    tpool = trp.pool_from_jax(
        {f.name: np.array(getattr(pool, f.name))
         for f in dataclasses.fields(pool)}, device="cpu")
    tcam = trd.CamView(torch.from_numpy(KMAT), torch.eye(4),
                       torch.from_numpy(rgb), torch.from_numpy(depth),
                       torch.zeros(H, W), 0)
    tstep = tgm.make_gsdf_step(tcfg, topt, W, H, L)
    jx = dict(cfg=jcfg, m=m, decoders=decoders, pool=pool, cam=jcam,
              slot=slot, local_idx=local_idx, params=params, state=state,
              step=jstep, opt=opt)
    tx = dict(cfg=tcfg, m=tm, decoders=td, pool=tpool, cam=tcam, slot=slot,
              local_idx=torch.from_numpy(np.array(local_idx)),
              params=tparams, opt=topt, step=tstep)
    return jx, tx


def _batches(jx, i):
    """The same SDF batch for both packages: drawn by the JAX pool, handed
    to the port as tensors."""
    b = jrp.pool_batch(jx["pool"], jax.random.PRNGKey(100 + i),
                       jx["cfg"].bs, 64)
    return b, tuple(torch.from_numpy(np.array(x)) for x in b)


METRIC_FIELDS = ("total", "rgb_l1", "ssim", "depth_l1", "normal",
                 "opacity_ent", "sky", "gs_sdf", "sdf_bce")


def _jleaves(v):
    """A JAX entry's leaves in the order of the port's ``param_leaves``."""
    if isinstance(v, dict):
        return list(v["w"]) + [b for b in v["b"] if b is not None]
    return list(v) if isinstance(v, tuple) else [v]


def _leaf_pairs(jparams, tparams):
    for key in jgm.gs_param_labels():
        jl = _jleaves(jparams[key])
        tl = list(tgm.param_leaves(tparams, key))
        assert len(jl) == len(tl), key
        for i, (a, b) in enumerate(zip(jl, tl)):
            yield f"{key}[{i}]", np.asarray(a), b


def _jax_grads(jx, batch):
    cfg = jx["cfg"]
    cam_loss = jgm.make_cam_loss(cfg, W, H)
    batch_terms = jgm.make_sdf_batch_terms(cfg)
    kidx = jnpm.query_neighbor_idx(jx["m"], batch[0], cfg.query_nn_k,
                                   cfg.num_nei_cells, cfg.search_alpha)

    def loss_fn(p):
        m, d = jgm.apply_gs_params(jx["m"], jx["decoders"], p)
        total, _, _ = cam_loss(p, m, d, jx["local_idx"], jx["cam"],
                               jnp.int32(jx["slot"]))
        bce, eik = batch_terms(m, d, batch, kidx)
        return total + bce + cfg.weight_e * eik

    return jax.jit(jax.grad(loss_fn))(jx["params"])


@pytest.mark.parametrize("gs_type", ["gaussian_surfel", "3d_gs"])
def test_one_step_matches(gs_type):
    jx, tx = _setup(gs_type)
    jb, tb = _batches(jx, 0)
    gj = _jax_grads(jx, jb)
    jp, jstate, jmet, _ = jx["step"](
        jx["params"], jx["state"], jx["m"], jx["decoders"], jx["local_idx"],
        jx["cam"], jnp.int32(jx["slot"]), jb, jnp.asarray(False))
    tmet, (tbins, tmeans, tcontrib) = tx["step"](
        tx["params"], tx["m"], tx["decoders"], tx["local_idx"], tx["cam"],
        tx["slot"], tb, False)
    assert not bool(jmet.nonfinite) and not bool(tmet.nonfinite)
    for f in METRIC_FIELDS:
        np.testing.assert_allclose(float(getattr(tmet, f)),
                                   float(getattr(jmet, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    assert abs(float(tmet.psnr) - float(jmet.psnr)) < 1e-3
    assert int(tmet.n_overflow) == int(jmet.n_overflow)
    assert float(jmet.gs_sdf) > 0          # the GS-SDF samples were live
    assert tcontrib.shape == (L * 2,) and float(tcontrib.sum()) > 0
    assert tbins.counts.shape == (12,) and not tmeans.requires_grad

    lr = {"feat": 0.02, "geo_mlp": 2e-3, "gs_mlp": 2e-3,
          "exposure": jx["cfg"].lr_exposure, "cam_delta": jx["cfg"].lr_cam_dt}
    labels = jgm.gs_param_labels()
    for (name, g, leaf) in _leaf_pairs(gj, tx["params"]):
        scale = max(np.abs(g).max(), 1e-8)
        np.testing.assert_allclose(leaf.grad.numpy(), g, atol=2e-3 * scale,
                                   rtol=2e-3, err_msg="grad " + name)
    for (name, a, leaf) in _leaf_pairs(jp, tx["params"]):
        step = lr[labels[name.split("[")[0]]]
        d = np.abs(leaf.detach().numpy() - a)
        assert d.max() <= 2e-2 * step + 1e-7, (name, d.max())
        assert (d > 1e-3 * step + 1e-7).mean() <= 0.01, name
    # exposure is off and the pose is not trained: zero gradients, yet the
    # step counts advanced as optax's did
    assert not tx["params"]["cam_delta"].grad.any()
    st = tx["opt"].state[tx["params"]["cam_delta"]]
    assert st["step"] == int(jstate.inner_states["cam_delta"][0][0].count) == 1


def _run_ten(jx, tx, plan):
    """Ten steps in each package with the same batches; ``plan[i]`` says
    whether step i reuses the cached table and contributions."""
    jp, jstate = jx["params"], jx["state"]
    jent = tent = None
    jl, tl, jps, tps, drifted = [], [], [], [], []
    for i, use in enumerate(plan):
        jb, tb = _batches(jx, i)
        jkw = dict(bins=jent[0], bin_means=jent[1], cached_contrib=jent[2],
                   use_bins=True) if use else {}
        jp, jstate, jmet, jextra = jx["step"](
            jp, jstate, jx["m"], jx["decoders"], jx["local_idx"], jx["cam"],
            jnp.int32(jx["slot"]), jb, jnp.asarray(False), **jkw)
        tkw = dict(bins=tent[0], bin_means=tent[1], cached_contrib=tent[2],
                   use_bins=True) if use else {}
        tmet, textra = tx["step"](
            tx["params"], tx["m"], tx["decoders"], tx["local_idx"],
            tx["cam"], tx["slot"], tb, False, **tkw)
        if use:
            drifted.append((not np.array_equal(np.asarray(jextra[1]),
                                               np.asarray(jent[1])),
                            textra[1] is not tent[1]))
            jent = (jextra[0], jextra[1], jent[2])
            tent = (textra[0], textra[1], tent[2])
        else:
            jent, tent = jextra, textra
        np.testing.assert_array_equal(np.asarray(jent[0].counts),
                                      tent[0].counts.numpy())
        jl.append(float(jmet.total))
        tl.append(float(tmet.total))
        jps.append(float(jmet.psnr))
        tps.append(float(tmet.psnr))
    return jl, tl, jps, tps, drifted


@pytest.mark.parametrize("gs_type", ["gaussian_surfel", "3d_gs"])
def test_ten_steps_track(gs_type):
    """Steps 0, 4 and 8 bin afresh and refresh the contributions; the
    others reuse the cached table and contributions."""
    jx, tx = _setup(gs_type)
    plan = [i % 4 != 0 for i in range(10)]
    jl, tl, jps, tps, drifted = _run_ten(jx, tx, plan)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert jps[-1] > jps[0] and tps[-1] > tps[0], (jps, tps)
    assert abs(tps[-1] - jps[-1]) < 0.05
    assert not any(j or t for j, t in drifted)    # 4 px guard: no rebin


def test_drift_guard_rebins_in_both():
    """With a guard of a thousandth of a pixel every reused table is
    rebuilt inside the step, in both packages."""
    jx, tx = _setup("gaussian_surfel", raster_rebin_drift_px=1e-3)
    jl, tl, _, _, drifted = _run_ten(jx, tx, [False, True, True])
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert drifted == [(True, True), (True, True)]
