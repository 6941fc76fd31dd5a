"""Differentiable SSIM.

Counterpart of ``pings_tpu/ops/ssim.py``: a separable 11-tap Gaussian
window (sigma 1.5) applied as two 1-D convolutions with no padding
("valid"), the standard constants C1 = 0.01^2, C2 = 0.03^2, and the mean
over the valid region. It never was a kernel of the JAX package, so the
blur is ``torch.nn.functional.conv2d``.

Layout: images are (H, W, C) in [0, 1].
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from pings_tpu_torch.utils import trace


@functools.lru_cache(maxsize=None)
def _gauss_kernel(window: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(window) - window // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, window: int = 11) -> torch.Tensor:
    """Separable Gaussian blur, no padding. x: (H, W, C) ->
    (H - window + 1, W - window + 1, C)."""
    with trace.read("ssim_window"):
        k = torch.as_tensor(_gauss_kernel(window), device=x.device)
    h = F.conv2d(x.permute(2, 0, 1)[:, None], k[None, None, :, None])
    hw = F.conv2d(h, k[None, None, None, :])
    return hw[:, 0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window: int = 11,
         c1: float = 0.01**2, c2: float = 0.03**2) -> torch.Tensor:
    """Mean SSIM over the valid region. img: (H, W, C) in [0, 1]."""
    mu1 = _blur(img1, window)
    mu2 = _blur(img2, window)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window) - mu2_sq
    sigma12 = _blur(img1 * img2, window) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map)


def dssim_loss(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """(1 - SSIM) / 2, the form the GS training loss uses."""
    return (1.0 - ssim(img1, img2)) / 2.0
