"""pings_tpu_torch.models.field vs pings_tpu.models.field (CPU).

Map and decoders carried across from the JAX package; SDF, colour and the
finite-difference gradient within atol 1e-5 + rtol 1e-4 (the MLP matmuls
sum in another order; the gradient divides a difference of two SDFs by
0.08 m), ``check_invalid_gs`` masks equal except where |SDF| sits within
1e-5 of its threshold."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pings_tpu.models import decoder as jdec
from pings_tpu.models import field as jfield
from pings_tpu.models import neural_points as jnpm
from pings_tpu_torch.models import decoder as tdec
from pings_tpu_torch.models import field as tfield
from pings_tpu_torch.models import neural_points as tnpm
from test_torch_gs_step import _flat_dec
from test_torch_query import _queries, build_maps
from torch_slam_helpers import one_torch_thread  # noqa: F401

SIG = 0.55 * 0.06


def _both(rng):
    cfg, m, tm = build_maps(rng, geo_mlp_hidden_dim=16,
                            color_mlp_hidden_dim=16,
                            gaussian_mlp_hidden_dim=16)
    d = jdec.init_decoders(jax.random.PRNGKey(4), cfg)
    return cfg, m, tm, d, tdec.decoders_from_jax(_flat_dec(d), "cpu")


def test_sdf_color_and_fd_gradient(rng):
    cfg, m, tm, d, td = _both(rng)
    q = _queries(rng, m)[0]
    js, jstd, jv = jfield.sdf_at(m, d, jnp.asarray(q), SIG, k=6, stencil_r=2)
    ts, tstd, tv = tfield.sdf_at(tm, td, torch.from_numpy(q), SIG, k=6,
                                 stencil_r=2)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6,
                               rtol=1e-4)
    np.testing.assert_allclose(tstd.numpy(), np.asarray(jstd), atol=1e-5,
                               rtol=1e-3)
    jq = jnpm.query_feature(m, jnp.asarray(q), 6, 2, 0.2)
    tq = tnpm.query_feature(tm, torch.from_numpy(q), 6, 2, 0.2)
    jc, _ = jfield.color_from_query(d, jq)
    tc, _ = tfield.color_from_query(td, tq)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6,
                               rtol=1e-5)
    jg = jfield.sdf_grad_numerical_nn(m, d, jnp.asarray(q), jq.nn_idx, SIG,
                                      0.04, 2, 0.2)
    tg = tfield.sdf_grad_numerical_nn(tm, td, torch.from_numpy(q), tq.nn_idx,
                                      SIG, 0.04, 2, 0.2)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-4)


def test_check_invalid_gs_matches(rng):
    cfg, m, tm, d, td = _both(rng)
    L = 1024
    jidx = jnp.nonzero(m.local_mask, size=L, fill_value=m.capacity)[0]
    tidx = torch.from_numpy(np.array(jidx))
    pts = m.positions[jidx]
    sdf = np.abs(np.asarray(jfield.sdf_at(m, d, pts, SIG, k=6,
                                          stencil_r=2)[0]))
    thre = float(np.median(sdf))        # half the points on either side
    m = m.replace(valid_gs_mask=m.valid_mask)
    tm.valid_gs_mask = tm.valid_mask.clone()
    jm = jfield.check_invalid_gs(m, d, jidx, SIG, jnp.float32(1.0),
                                 jnp.float32(thre), k=6, stencil_r=2,
                                 min_nn=4)
    before = tm.valid_gs_mask.clone()
    tm2 = tfield.check_invalid_gs(tm, td, tidx, SIG, 1.0, thre, k=6,
                                  stencil_r=2, min_nn=4)
    assert torch.equal(tm.valid_gs_mask, before)      # input map untouched
    jmask, tmask = np.asarray(jm.valid_gs_mask), tm2.valid_gs_mask.numpy()
    rows = np.asarray(jidx)
    near = np.zeros_like(jmask)
    near[rows[np.abs(sdf - thre) < 1e-5]] = True
    np.testing.assert_array_equal(jmask[~near], tmask[~near])
    changed = jmask != np.asarray(m.valid_gs_mask)
    assert changed.sum() > 50 and not tmask[-1]
