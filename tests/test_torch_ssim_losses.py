"""pings_tpu_torch.ops.ssim and .mapping.losses vs the JAX package (CPU).

Same numpy inputs through both; values within atol 1e-6 + rtol 1e-5
(float32 reductions in another order), gradients of the differentiable
ones within atol 1e-6 + rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pings_tpu.mapping import losses as jl
from pings_tpu.ops import ssim as jssim
from pings_tpu_torch.mapping import losses as tl
from pings_tpu_torch.ops import ssim as tssim
from torch_slam_helpers import one_torch_thread  # noqa: F401

H, W = 40, 56


def _imgs(rng):
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


def _close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def test_blur_and_ssim(rng):
    a, b = _imgs(rng)
    np.testing.assert_array_equal(jssim._gauss_kernel(), tssim._gauss_kernel())
    jb = jssim._blur(jnp.asarray(a))
    tb = tssim._blur(torch.from_numpy(a))
    assert tb.shape == (H - 10, W - 10, 3) == jb.shape
    _close(tb, jb)
    ta = torch.from_numpy(a).requires_grad_(True)
    d = tssim.dssim_loss(ta, torch.from_numpy(b))
    _close(d, jssim.dssim_loss(jnp.asarray(a), jnp.asarray(b)))
    d.backward()
    gj = jax.grad(lambda x: jssim.dssim_loss(x, jnp.asarray(b)))(
        jnp.asarray(a))
    _close(ta.grad, gj, rtol=1e-4)
    _close(tssim.ssim(torch.from_numpy(a), torch.from_numpy(a)), 1.0)


def _cases(rng):
    n = 300
    a, b = _imgs(rng)
    alpha = rng.uniform(0, 1, (H, W)).astype(np.float32)
    sky = (rng.uniform(size=(H, W)) < 0.2).astype(np.float32)
    mask = rng.uniform(size=(H, W)) < 0.6
    nrm = rng.normal(size=(H, W, 3)).astype(np.float32)
    nrm2 = rng.normal(size=(H, W, 3)).astype(np.float32)
    depth = rng.uniform(1, 3, (H, W)).astype(np.float32)
    pred = rng.normal(size=n).astype(np.float32) * 0.2
    lab = rng.normal(size=n).astype(np.float32) * 0.2
    wgt = rng.uniform(0.1, 1, n).astype(np.float32)
    valid = rng.uniform(size=n) < 0.8
    grad = rng.normal(size=(n, 3)).astype(np.float32)
    ray = rng.normal(size=(n, 3)).astype(np.float32)
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    col = rng.uniform(size=(n, 3)).astype(np.float32)
    col2 = rng.uniform(size=(n, 3)).astype(np.float32)
    logp = np.log(rng.dirichlet(np.ones(5), n)).astype(np.float32)
    cls = rng.integers(0, 5, n).astype(np.int32)
    scales = rng.uniform(0.01, 0.3, (n, 3)).astype(np.float32)
    vf = valid.astype(np.float32)
    return {
        "sdf_bce_loss": (pred, lab, wgt, 0.06, vf),
        "eikonal_loss": (grad, vf),
        "color_l1_loss": (col, col2, vf),
        "sem_nll_loss": (logp, cls, vf),
        "l1_masked": (a, b),
        "l1_masked/mask": (depth, depth[::-1].copy(), mask),
        "opacity_entropy_loss": (alpha,),
        "sky_bce_loss": (alpha, sky),
        "normal_consistency_loss": (nrm, nrm2, mask),
        "isotropic_loss": (scales, vf, 2),
        "area_loss": (scales, vf, 0.3, 3),
        "psnr": (a, b),
        "psnr/mask": (a, b, mask[..., None]),
        "normal_smooth_loss": (nrm, depth, mask, 0.3, 0.5),
        "tukey_loss": (a, b, 0.5),
        "tukey_loss/l1": (a, b, 0.0),
        "incidence_weights": (grad, ray, 0.1),
    }


NAMES = ["sdf_bce_loss", "eikonal_loss", "color_l1_loss", "sem_nll_loss",
         "l1_masked", "l1_masked/mask", "opacity_entropy_loss",
         "sky_bce_loss", "normal_consistency_loss", "isotropic_loss",
         "area_loss", "psnr", "psnr/mask", "normal_smooth_loss",
         "tukey_loss", "tukey_loss/l1", "incidence_weights"]


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches(rng, name):
    args = _cases(rng)[name]
    fn = name.split("/")[0]
    ja = [jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args]
    ta = [torch.from_numpy(x) if isinstance(x, np.ndarray) else x
          for x in args]
    vj = getattr(jl, fn)(*ja)
    first = ta[0].requires_grad_(True)
    vt = getattr(tl, fn)(*ta)
    _close(vt, vj)
    vt.sum().backward()
    gj = jax.grad(lambda x: jnp.sum(getattr(jl, fn)(x, *ja[1:])))(ja[0])
    _close(first.grad, gj, rtol=1e-4)
