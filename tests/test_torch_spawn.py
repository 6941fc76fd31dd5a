"""pings_tpu_torch.models.spawn vs pings_tpu.models.spawn (CPU).

Tolerance: atol 1e-5 on every spawned attribute (float32 MLPs and
quaternion algebra in a different summation order); the validity mask
must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.config import Config
from pings_tpu.models import decoder as jd
from pings_tpu.models import spawn as jsp
from pings_tpu_torch.models import decoder as td
from pings_tpu_torch.models import spawn as tsp

ATOL = 1e-5


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"dec" + jax.tree_util.keystr(kp): np.asarray(x)
            for kp, x in leaves}


@pytest.mark.parametrize("gs_type", ["gaussian_surfel", "3d_gs"])
def test_spawn_gaussians(rng, gs_type):
    cfg = Config(feature_dim=8, color_feature_dim=8, spawn_n_gaussian=4,
                 gaussian_mlp_hidden_dim=32, gs_type=gs_type,
                 voxel_size_m=0.3)
    jdec = jd.init_decoders(jax.random.PRNGKey(1), cfg)
    tdec = td.decoders_from_jax(_flat(jdec), device="cpu")
    L = 200
    arrs = [
        rng.normal(size=(L, 3)).astype(np.float32) * 5,
        rng.normal(size=(L, 4)).astype(np.float32),
        rng.normal(size=(L, 8)).astype(np.float32),
        rng.normal(size=(L, 8)).astype(np.float32),
        rng.uniform(size=(L, 3)).astype(np.float32),
        rng.uniform(size=L) < 0.9,
    ]
    visible = rng.uniform(size=L) < 0.8
    origin = np.array([0.5, -1.0, 0.2], np.float32)
    kw = jsp.spawn_kwargs_from_cfg(cfg)
    assert kw == tsp.spawn_kwargs_from_cfg(cfg)
    jg = jsp.spawn_gaussians(jsp.LocalPointData(*map(jnp.asarray, arrs)),
                             jdec, jnp.asarray(origin), jnp.asarray(visible),
                             **kw)
    tg = tsp.spawn_gaussians(
        tsp.LocalPointData(*map(torch.from_numpy, arrs)), tdec,
        torch.from_numpy(origin), torch.from_numpy(visible), **kw)
    assert jg._fields == tg._fields
    for name, a, b in zip(jg._fields, jg, tg):
        if name == "valid":
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=ATOL,
                                       rtol=0, err_msg=name)
    assert 0 < int(tg.valid.sum()) < L * 4
