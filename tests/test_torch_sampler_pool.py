"""pings_tpu_torch.mapping.sampler and .pool vs the JAX package (CPU).

``jax.random`` cannot be reproduced by a ``torch.Generator``, so the draws
the JAX functions make from their keys are recomputed here from the same
keys and injected into the port's functions. Samples within 5e-6
(positions and ranges of tens of metres in float32, whose last bit is 2e-6;
XLA contracts a multiply and an add where torch rounds twice); pool
contents exactly equal (the port is handed the JAX package's samples)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.config import Config as JConfig
from pings_tpu.mapping import pool as jrp
from pings_tpu.mapping import sampler as jsm
from pings_tpu_torch.config import Config as TConfig
from pings_tpu_torch.mapping import pool as trp
from pings_tpu_torch.mapping import sampler as tsm

T = torch.from_numpy


def _scan(rng, n=500):
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 8
    pts[3] = [1.0, 2.0, 0.5]
    col = rng.uniform(size=(n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.9
    origin = np.array([1.0, 2.0, 0.5], np.float32)   # ray 3 has no length
    sem = rng.integers(-1, 4, n).astype(np.int32)
    inc = rng.uniform(size=n).astype(np.float32)
    return pts, col, mask, origin, sem, inc


def _draws(key, n, cfg):
    ks, kf, kb = jax.random.split(key, 3)
    return tuple(T(np.array(x)) for x in (
        jax.random.normal(ks, (n, cfg.surface_sample_n)),
        jax.random.uniform(kf, (n, cfg.free_front_n)),
        jax.random.uniform(kb, (n, cfg.free_behind_n))))


@pytest.mark.parametrize("extras", [False, True])
def test_sample_rays_matches(rng, extras):
    over = dict(loss_weight_on=extras, surface_sample_n=3, free_front_n=2)
    jcfg, tcfg = JConfig.load(overrides=over), TConfig.load(overrides=over)
    pts, col, mask, origin, sem, inc = _scan(rng)
    key = jax.random.PRNGKey(5)
    js = jsm.sample_rays_cfg(
        key, jnp.asarray(pts), jnp.asarray(col), jnp.asarray(mask),
        jnp.asarray(origin), jcfg,
        sem_labels=jnp.asarray(sem) if extras else None,
        incid_cos=jnp.asarray(inc) if extras else None)
    ts = tsm.sample_rays_cfg(
        None, T(pts), T(col), T(mask), T(origin), tcfg,
        sem_labels=T(sem) if extras else None,
        incid_cos=T(inc) if extras else None,
        draws=_draws(key, len(pts), jcfg))
    for f in js._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, atol=5e-6, rtol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, f)
    assert not ts.valid.numpy().reshape(len(pts), -1)[3].any()


def test_sample_rays_generator_statistics():
    """With its own generator: the jitter has the configured spread and
    the free-space samples lie in their intervals."""
    g = torch.Generator().manual_seed(0)
    n = 4000
    pts = torch.tensor([[10.0, 0, 0]]).repeat(n, 1)
    s = tsm.sample_rays(g, pts, torch.zeros(n, 3),
                        torch.ones(n, dtype=torch.bool), torch.zeros(3))
    lab = s.sdf_label.reshape(n, 7)
    assert torch.all(lab[:, 0] == 0)
    assert abs(float(lab[:, 1:4].std()) - 0.25) < 0.01
    assert torch.all((lab[:, 4:6] >= 0.2 - 1e-5) & (lab[:, 4:6] <= 7 + 1e-5))
    assert torch.all((lab[:, 6] <= -0.2 + 1e-5) & (lab[:, 6] >= -1 - 1e-5))
    s2 = tsm.sample_rays(torch.Generator().manual_seed(0), pts,
                         torch.zeros(n, 3), torch.ones(n, dtype=torch.bool),
                         torch.zeros(3))
    assert torch.equal(s.points, s2.points)


def _pool_equal(jp, tp, skip_rows=None):
    for f in dataclasses.fields(jp):
        a, b = np.asarray(getattr(jp, f.name)), getattr(tp, f.name).numpy()
        assert a.dtype == b.dtype, f.name
        if skip_rows is not None and a.ndim:
            a, b = np.delete(a, skip_rows, 0), np.delete(b, skip_rows, 0)
        np.testing.assert_array_equal(a, b, f.name)


def test_pool_insert_and_batch_match(rng):
    cap = 3000
    jp, tp = jrp.init_pool(cap), trp.init_pool(cap, device="cpu")
    _pool_equal(jp, tp)
    jcfg = JConfig.load()
    skip = np.zeros(0, np.int64)
    for fid in range(3):     # 500 rays x 7 samples: every insert overflows
        pts, col, mask, origin, _, _ = _scan(rng)
        js = jsm.sample_rays_cfg(jax.random.PRNGKey(fid), jnp.asarray(pts),
                                 jnp.asarray(col), jnp.asarray(mask),
                                 jnp.asarray(origin), jcfg)
        ts = tsm.SdfSamples(*(T(np.array(x)) for x in js))
        key = jax.random.PRNGKey(50 + fid)
        count = int(jp.count)
        rnd = np.array(jax.random.randint(key, (js.points.shape[0],), 0,
                                          max(count, 1)))
        jp = jrp.pool_insert(jp, js, jnp.int32(fid), key)
        tp = trp.pool_insert(tp, ts, fid, rnd=T(rnd))
        # overflow samples that drew the same slot: which one lands there
        # is not defined in either package (and stays so in later frames)
        valid = np.asarray(js.valid)
        over = valid & (np.cumsum(valid) - 1 >= cap - count)
        slots, n_hit = np.unique(rnd[over], return_counts=True)
        skip = np.union1d(skip, slots[n_hit > 1])
        assert len(skip) < cap // 2
        _pool_equal(jp, tp, skip_rows=skip)
    assert int(tp.count) == cap and int(tp.new_count) < 500 * 7
    # a pool carried across, then the same batch from the same draws
    tp = trp.pool_from_jax({f.name: np.array(getattr(jp, f.name))
                            for f in dataclasses.fields(jp)}, device="cpu")
    _pool_equal(jp, tp)
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    bs, bs_new = 256, 64
    hist = jax.random.randint(k1, (bs - bs_new,), 0, max(int(jp.count), 1))
    off = jax.random.randint(k2, (bs_new,), 0, max(int(jp.new_count), 1))
    jb = jrp.pool_batch(jp, key, bs, bs_new)
    tb = trp.pool_batch(tp, None, bs, bs_new,
                        draws=(T(np.array(hist)), T(np.array(off))))
    assert len(jb) == len(tb) == 7
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_pool_batch_generator_ranges():
    tp = trp.init_pool(100, device="cpu")
    g = torch.Generator().manual_seed(1)
    b = trp.pool_batch(tp, g, 16, 4)
    assert not b[4].any()                      # an empty pool: all invalid
    n = 30
    s = tsm.SdfSamples(
        torch.arange(n * 3, dtype=torch.float32).reshape(n, 3),
        torch.arange(n, dtype=torch.float32), torch.zeros(n, 3),
        torch.zeros(n, 3), torch.zeros(n, dtype=torch.int32), torch.ones(n),
        torch.zeros(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool))
    tp = trp.pool_insert(tp, s, 0, g)
    tp = trp.pool_insert(tp, s._replace(sdf_label=s.sdf_label + 100), 1, g)
    assert int(tp.count) == 60 and int(tp.new_begin) == 30
    b = trp.pool_batch(tp, g, 64, 16)
    assert b[4].all()
    assert (b[1][:16] >= 100).all()            # the fresh part
    assert (b[1][16:] < 130).all() and (b[1][16:] < 100).any()
