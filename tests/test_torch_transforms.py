"""pings_tpu_torch.ops.transforms vs pings_tpu.ops.transforms (CPU).

Tolerance: atol 1e-6 — both sides run the same float32 formulas; only the
order of a few reductions differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.ops import transforms as jt
from pings_tpu_torch.ops import transforms as tt
from torch_slam_helpers import one_torch_thread  # noqa: F401

ATOL = 1e-6


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=ATOL, rtol=0)


@pytest.fixture
def quats(rng):
    return rng.normal(size=(64, 4)).astype(np.float32)


def test_quat_normalize(quats):
    _close(jt.quat_normalize(jnp.asarray(quats)),
           tt.quat_normalize(torch.from_numpy(quats)))


def test_quat_multiply(rng, quats):
    b = rng.normal(size=(64, 4)).astype(np.float32)
    _close(jt.quat_multiply(jnp.asarray(quats), jnp.asarray(b)),
           tt.quat_multiply(torch.from_numpy(quats), torch.from_numpy(b)))


def test_quat_rotate_broadcast(rng, quats):
    q = quats / np.linalg.norm(quats, axis=-1, keepdims=True)
    v = rng.normal(size=(64, 5, 3)).astype(np.float32)
    _close(jt.quat_rotate(jnp.asarray(q)[:, None], jnp.asarray(v)),
           tt.quat_rotate(torch.from_numpy(q)[:, None], torch.from_numpy(v)))


def test_quat_to_rotmat(quats):
    _close(jt.quat_to_rotmat(jnp.asarray(quats)),
           tt.quat_to_rotmat(torch.from_numpy(quats)))


@pytest.mark.parametrize("scale", [1e-5, 0.3, 2.0])
def test_se3_exp(rng, scale):
    """Both branches of the small-angle switch (t2 < 1e-8 and above)."""
    xi = (rng.normal(size=(16, 6)) * scale).astype(np.float32)
    _close(jt.se3_exp(jnp.asarray(xi)), tt.se3_exp(torch.from_numpy(xi)))
    _close(jt.so3_exp(jnp.asarray(xi[:, 3:])),
           tt.so3_exp(torch.from_numpy(xi[:, 3:])))
    _close(jt.skew(jnp.asarray(xi[:, :3])), tt.skew(torch.from_numpy(xi[:, :3])))
