"""pings_tpu_torch.models.decoder vs pings_tpu.models.decoder (CPU).

The JAX decoders are flattened into the checkpoint key format
(``dec['name']['w'][i]``, as ``SlamSystem.save`` writes it) and carried
across with ``decoders_from_jax``. Tolerance: atol 1e-5 on every head
(float32 matmuls of width 64 in a different summation order)."""

import jax
import numpy as np
import pytest
import torch

from pings_tpu.config import Config
from pings_tpu.models import decoder as jd
from pings_tpu_torch.models import decoder as td
from torch_slam_helpers import one_torch_thread  # noqa: F401

ATOL = 1e-5


def flatten_decoders(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"dec" + jax.tree_util.keystr(kp): np.asarray(leaf)
            for kp, leaf in leaves}


@pytest.fixture
def decoders():
    cfg = Config(feature_dim=8, color_feature_dim=8, spawn_n_gaussian=4,
                 geo_mlp_hidden_dim=32, color_mlp_hidden_dim=32,
                 sem_mlp_hidden_dim=32, gaussian_mlp_hidden_dim=32)
    jdec = jd.init_decoders(jax.random.PRNGKey(3), cfg)
    return jdec, td.decoders_from_jax(flatten_decoders(jdec), device="cpu")


def test_weights_carried_exactly(decoders):
    jdec, tdec = decoders
    assert set(jdec) == set(tdec)
    for name in jdec:
        for kind in ("w", "b"):
            for a, b in zip(jdec[name][kind], tdec[name][kind]):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_every_head(decoders, rng):
    jdec, tdec = decoders
    f = lambda name: jdec[name]["w"][0].shape[0]
    x = {n: rng.normal(size=(50, f(n))).astype(np.float32) for n in jdec}
    j = lambda n: jax.numpy.asarray(x[n])
    t = lambda n: torch.from_numpy(x[n])
    pairs = [
        (jd.sdf_head(jdec["sdf"], j("sdf"), 0.7),
         td.sdf_head(tdec["sdf"], t("sdf"), 0.7)),
        (jd.color_head(jdec["color"], j("color")),
         td.color_head(tdec["color"], t("color"))),
        (jd.sem_head(jdec["sem"], j("sem")),
         td.sem_head(tdec["sem"], t("sem"))),
    ]
    for name in ("gauss_xyz", "gauss_rot", "gauss_scale", "gauss_alpha",
                 "gauss_color"):
        pairs.append((jd.gaussian_head(jdec[name], j(name), 4),
                      td.gaussian_head(tdec[name], t(name), 4)))
    for a, b in pairs:
        assert np.asarray(a).shape == tuple(b.shape)
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=ATOL,
                                   rtol=0)


def test_missing_biases_are_none():
    flat = {"dec['m']['w'][0]": np.ones((3, 4), np.float32),
            "dec['m']['w'][1]": np.ones((4, 2), np.float32)}
    d = td.decoders_from_jax(flat, device="cpu")
    assert d["m"]["b"] == [None, None]
    out = td.mlp_forward(d["m"], torch.ones(5, 3))
    assert torch.equal(out, torch.full((5, 2), 12.0))
