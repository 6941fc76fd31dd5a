"""pings_tpu_torch.models.neural_points vs pings_tpu (CPU).

The local-window masks and the gathered local indices are integer state:
they must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.config import Config
from pings_tpu.models import neural_points as jnpm
from pings_tpu.models import spawn as jsp
from pings_tpu_torch.models import neural_points as tnpm
from pings_tpu_torch.models import spawn as tsp

CAP = 6000


def _maps(rng):
    """The same random map in both packages (points clustered so the
    nearest-first truncation has whole bins to drop)."""
    cfg = Config(max_points=CAP, buffer_size=1 << 12, feature_dim=8,
                 color_feature_dim=8, voxel_size_m=0.3)
    n = CAP - 500
    pos = np.zeros((CAP + 1, 3), np.float32)
    pos[:n] = (rng.normal(size=(n, 3)) * [20.0, 20.0, 3.0]).astype(np.float32)
    fields = dict(
        positions=pos,
        quats=rng.normal(size=(CAP + 1, 4)).astype(np.float32),
        geo_feat=rng.normal(size=(CAP + 1, 8)).astype(np.float32),
        color_feat=rng.normal(size=(CAP + 1, 8)).astype(np.float32),
        rgb=rng.uniform(size=(CAP + 1, 3)).astype(np.float32),
        ts_create=rng.integers(0, 40, CAP + 1).astype(np.int32),
        ts_update=rng.integers(40, 80, CAP + 1).astype(np.int32),
        certainty=rng.uniform(size=CAP + 1).astype(np.float32),
        valid_mask=np.arange(CAP + 1) < n,
        valid_gs_mask=rng.uniform(size=CAP + 1) < 0.9,
        local_mask=np.zeros(CAP + 1, bool),
        count=np.int32(n),
        hash_table=np.full(1 << 12, -1, np.int32),
    )
    jm = jnpm.init_map(cfg).replace(
        **{k: jnp.asarray(v) for k, v in fields.items()})
    flat = {"map." + k: v for k, v in fields.items()}
    tm = tnpm.map_from_jax(flat, cfg.voxel_size_m, cfg.buffer_size,
                           device="cpu")
    travel = np.cumsum(rng.uniform(0, 2, 100)).astype(np.float32)
    return jm, tm, travel


@pytest.mark.parametrize("max_local,max_surround,window", [
    (None, None, np.inf),
    (1500, None, np.inf),
    (1500, 800, 40.0),
])
def test_compute_local_mask_exact(rng, max_local, max_surround, window):
    jm, tm, travel = _maps(rng)
    center = np.array([3.0, -2.0, 0.5], np.float32)
    ja, jb = jnpm.compute_local_mask(
        jm, jnp.asarray(center), jnp.int32(70), jnp.asarray(travel),
        jnp.float32(25.0), jnp.float32(window), max_local=max_local,
        max_surround=max_surround)
    ta, tb = tnpm.compute_local_mask(
        tm, torch.from_numpy(center), 70, torch.from_numpy(travel), 25.0,
        window, max_local=max_local, max_surround=max_surround)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    if max_local is not None:
        assert 0 < int(ta.sum()) <= max_local


def test_gather_local_data_exact(rng):
    jm, tm, travel = _maps(rng)
    center = np.zeros(3, np.float32)
    jmask, _ = jnpm.compute_local_mask(
        jm, jnp.asarray(center), jnp.int32(0), jnp.zeros(100),
        jnp.float32(15.0), jnp.float32(np.inf), max_local=1024)
    tmask, _ = tnpm.compute_local_mask(
        tm, torch.from_numpy(center), 0, torch.zeros(100), 15.0, np.inf,
        max_local=1024)
    jl = jsp.gather_local_data(jm, jmask, 1024)
    tl = tsp.gather_local_data(tm, tmask, 1024)
    assert 0 < int(tl.valid.sum()) < 1024          # padding exercised
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
