"""The port's SDF training step against the JAX package's (CPU), from the
same map, decoders, optimizer state and batches (carried across as
numpy): one step and a 3-step scan, losses within 1e-5 relative; the
parameters after the first step where the gradient is signal (Adam with
eps 1e-15 turns a gradient of rounding noise into a step of size lr, so
only entries whose gradient is above 1e-3 of the largest are held, within
1e-6); ``freeze`` (the decoders move by their weight decay only) and the
non-finite skip (nothing but the decay moves)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.data.base import dataset_factory
from pings_tpu.mapping import pool as jrp, sdf_mapper as jsm
from pings_tpu.mapping.sampler import sample_rays_cfg as jsample
from pings_tpu.models import decoder as jdec, neural_points as jnpm
from pings_tpu_torch.mapping import pool as trp, sdf_mapper as tsm
from torch_slam_helpers import (
    configs, decoders_to_torch, map_to_torch, one_torch_thread)  # noqa: F401

TOL = 1e-5


def _setup(**kw):
    jcfg, tcfg = configs(bs=512, bs_new_sample=128, weight_decay=1e-3, **kw)
    ds = dataset_factory("synthetic", "", "2:line", jcfg)
    f = ds[1]
    T = f["gt_pose"]
    pts = (f["points"] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    n = len(pts)
    m = jnpm.init_map(jcfg)
    m = jnpm.insert_points(m, jnp.asarray(pts), jnp.ones((n, 3)) * 0.5,
                           jnp.ones(n, bool),
                           jnp.tile(jnp.array([1.0, 0, 0, 0]), (n, 1)),
                           jnp.int32(0), jnp.zeros(8), jnp.float32(1e9))
    dec = jdec.init_decoders(jax.random.PRNGKey(0), jcfg)
    cols = jnp.asarray(np.abs(np.sin(pts)).astype(np.float32))
    s = jsample(jax.random.PRNGKey(1), jnp.asarray(pts), cols,
                jnp.ones(n, bool), jnp.asarray(T[:3, 3], jnp.float32), jcfg)
    pool = jrp.pool_insert(jrp.init_pool(jcfg.pool_capacity), s,
                           jnp.int32(0), jax.random.PRNGKey(2))
    opt, params, state = jsm.init_sdf_train(m, dec, jcfg)
    tm, td = map_to_torch(m), decoders_to_torch(dec)
    topt, tparams = tsm.init_sdf_train(tm, td, tcfg)
    tpool = trp.pool_from_jax({f.name: np.array(getattr(pool, f.name))
                               for f in dataclasses.fields(pool)}, "cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, m=m, dec=dec, pool=pool, opt=opt,
                params=params, state=state, tm=tm, td=td, topt=topt,
                tparams=tparams, tpool=tpool)


def _batch(pool, key, cfg):
    b = jrp.pool_batch(pool, key, cfg.bs, min(cfg.bs_new_sample, cfg.bs // 2))
    return b, tuple(torch.from_numpy(np.array(x)) for x in b)


def _leaves(params, key):
    """A JAX entry's leaves in the port's order: weights, then biases."""
    v = params[key]
    if not isinstance(v, dict):
        return [np.asarray(v)]
    return [np.asarray(x) for x in v["w"]] + [
        np.asarray(x) for x in v["b"] if x is not None]


def _close(tm, jm, names=("total", "bce", "eikonal", "color")):
    for k in names:
        a, b = float(getattr(tm, k)), float(getattr(jm, k))
        assert abs(a - b) <= TOL * max(abs(b), 1e-6), (k, a, b)


@pytest.fixture(scope="module")
def st():
    return _setup()


def test_one_step(st):
    jb, tb = _batch(st["pool"], jax.random.PRNGKey(5), st["jcfg"])
    jp, _, jmet = jsm.make_sdf_step(st["jcfg"], st["opt"])(
        st["params"], st["state"], jb, st["m"], st["dec"],
        jnp.asarray(False))
    tmet = tsm.make_sdf_step(st["tcfg"], st["topt"])(
        st["tparams"], tb, st["tm"], st["td"], False)
    _close(tmet, jmet)
    assert not bool(tmet.nonfinite) and float(tmet.bce) > 0.1
    for key in tsm.SDF_KEYS:
        for t, j in zip(tsm.sdf_param_leaves(st["tparams"], key),
                        _leaves(jp, key)):
            g = t.grad.numpy()
            sig = np.abs(g) > 1e-3 * np.abs(g).max()
            assert sig.sum() > 0, key
            np.testing.assert_allclose(t.detach().numpy()[sig], j[sig],
                                       atol=1e-6, err_msg=key)
            # rows with no gradient at all stay put (row-masked decay)
            if key in ("geo_feat", "color_feat"):
                still = ~np.any(g != 0, axis=-1)
                np.testing.assert_array_equal(
                    t.detach().numpy()[still], j[still])


def test_scan_of_three_steps():
    s = _setup()
    key = jax.random.PRNGKey(9)
    cfg = s["jcfg"]
    bs_new = min(cfg.bs_new_sample, cfg.bs // 2)
    draws = []
    for i in range(3):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i))
        draws.append(tuple(torch.from_numpy(np.array(a)) for a in (
            jax.random.randint(k1, (cfg.bs - bs_new,), 0,
                               jnp.maximum(s["pool"].count, 1)),
            jax.random.randint(k2, (bs_new,), 0,
                               jnp.maximum(s["pool"].new_count, 1)))))
    _, _, jmet = jsm.make_sdf_scan_step(cfg, s["opt"])(
        s["params"], s["state"], s["pool"], key, s["m"], s["dec"],
        jnp.asarray(False), 3)
    tmet = tsm.make_sdf_scan_step(s["tcfg"], s["topt"])(
        s["tparams"], s["tpool"], None, s["tm"], s["td"], False, 3,
        draws=draws)
    jmet = jax.tree.map(lambda x: x[0], jmet)
    _close(tmet, jmet)
    assert all(s["topt"].state[t]["step"] == 3
               for t in tsm.sdf_param_leaves(s["tparams"]))


@pytest.mark.parametrize("nan", [False, True])
def test_freeze_and_nonfinite_skip(nan):
    s = _setup()
    jb, tb = _batch(s["pool"], jax.random.PRNGKey(6), s["jcfg"])
    if nan:
        # a NaN label: the loss and every gradient are NaN
        jb = (jb[0], jb[1].at[3].set(jnp.nan)) + tuple(jb[2:])
        tb = (tb[0], torch.from_numpy(np.array(jb[1]))) + tb[2:]
    before = {k: [t.detach().clone() for t in tsm.sdf_param_leaves(
        s["tparams"], k)] for k in tsm.SDF_KEYS}
    jp, _, jmet = jsm.make_sdf_step(s["jcfg"], s["opt"])(
        s["params"], s["state"], jb, s["m"], s["dec"], jnp.asarray(True))
    tmet = tsm.make_sdf_step(s["tcfg"], s["topt"])(
        s["tparams"], tb, s["tm"], s["td"], True)
    assert bool(tmet.nonfinite) == bool(jmet.nonfinite) == nan
    lr, wd = s["tcfg"].lr_mlp_base, s["tcfg"].weight_decay
    for key in tsm.SDF_KEYS:
        for t, b, j in zip(tsm.sdf_param_leaves(s["tparams"], key),
                           before[key], _leaves(jp, key)):
            if key in ("sdf", "color") or nan:
                assert not t.grad.any(), key
            if key in ("sdf", "color"):
                # the first step with a zero gradient: weight decay only
                np.testing.assert_allclose(t.detach().numpy(),
                                           (b * (1 - lr * wd)).numpy(),
                                           rtol=1e-6, atol=1e-9)
                np.testing.assert_allclose(t.detach().numpy(), j,
                                           rtol=1e-6, atol=1e-9)
            elif nan:
                np.testing.assert_array_equal(t.detach().numpy(), j)
                np.testing.assert_array_equal(t.detach(), b)
    if not nan:
        _close(tmet, jmet)
