"""The helpers that no path of either package calls, port vs JAX (CPU):
``models.field.sdf_grad_numerical``, ``models.neural_points.memory_bytes``,
``models.spawn.empty_spawned`` and ``ops.transforms.safe_normalize``,
``quat_conjugate`` and ``se3_inverse``.

Tolerances: the finite-difference gradient as ``test_torch_field.py``
(atol 1e-5 + rtol 1e-4: the MLP matmuls sum in another order and a
difference of two SDFs is divided by 0.08 m); the transforms atol 1e-6
(the same float32 formulas, a few reductions in another order); the
memory model and the empty buffer exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.models import field as jfield
from pings_tpu.models import neural_points as jnpm
from pings_tpu.models import spawn as jspawn
from pings_tpu.ops import transforms as jt
from pings_tpu_torch.models import field as tfield
from pings_tpu_torch.models import neural_points as tnpm
from pings_tpu_torch.models import spawn as tspawn
from pings_tpu_torch.ops import transforms as tt
from test_torch_field import SIG, _both
from test_torch_query import _queries
from torch_slam_helpers import one_torch_thread  # noqa: F401

ATOL = 1e-6


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol, rtol=0)


def test_sdf_grad_numerical(rng):
    cfg, m, tm, d, td = _both(rng)
    q = _queries(rng, m)[0]
    jg = jfield.sdf_grad_numerical(m, d, jnp.asarray(q), SIG, 0.04, k=6,
                                   stencil_r=2)
    tg = tfield.sdf_grad_numerical(tm, td, torch.from_numpy(q), SIG, 0.04,
                                   k=6, stencil_r=2)
    assert tg.shape == (q.shape[0], 3)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-4)


def test_memory_bytes(rng):
    _, m, tm, _, _ = _both(rng)
    assert int(tm.count) > 0
    assert tnpm.memory_bytes(tm) == jnpm.memory_bytes(m)


@pytest.mark.parametrize("n", [1, 37])
def test_empty_spawned(n):
    j = jspawn.empty_spawned(n)
    t = tspawn.empty_spawned(n, device="cpu")
    assert t._fields == j._fields
    for f in j._fields:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_safe_normalize(rng):
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[:3] = 0.0                                   # the zero vector stays 0
    _close(jt.safe_normalize(jnp.asarray(v)),
           tt.safe_normalize(torch.from_numpy(v)))
    # the gradient at v = 0 is finite
    g = torch.func.grad(lambda x: tt.safe_normalize(x).sum())(
        torch.zeros(3))
    assert torch.isfinite(g).all()


def test_quat_conjugate(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    _close(jt.quat_conjugate(jnp.asarray(q)),
           tt.quat_conjugate(torch.from_numpy(q)))
    # q ⊗ q* is |q|^2 times the identity
    qt = tt.quat_normalize(torch.from_numpy(q))
    ident = tt.quat_multiply(qt, tt.quat_conjugate(qt))
    torch.testing.assert_close(
        ident, torch.tensor([1.0, 0, 0, 0]).expand(64, 4), atol=1e-6,
        rtol=0)


def test_se3_inverse(rng):
    xi = (rng.normal(size=(16, 6)) * [2, 2, 2, 0.8, 0.8, 0.8]).astype(
        np.float32)
    T = np.array(jt.se3_exp(jnp.asarray(xi)))
    _close(jt.se3_inverse(jnp.asarray(T)),
           tt.se3_inverse(torch.from_numpy(T)), atol=1e-5)
    Ti = tt.se3_inverse(torch.from_numpy(T))
    torch.testing.assert_close(Ti @ torch.from_numpy(T),
                               torch.eye(4).expand(16, 4, 4), atol=1e-5,
                               rtol=0)
