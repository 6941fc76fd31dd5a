"""LPIPS perceptual distance in PyTorch.

Counterpart of ``pings_tpu/eval/lpips.py``: the VGG16 conv plan, ``_TAPS``,
``_SHIFT`` and ``_SCALE`` (:40-48), ``_features`` (:76) and ``lpips``
(:115) as torch ops (the JAX package computes the convolutions with XLA,
not in a Pallas kernel; here they are ``torch.nn.functional.conv2d``).
Unit-normalised channel features at the five tapped ReLU stages, 1x1
linear heads, spatial mean, stage sum.

Weights resolve as in the JAX package:

1. ``PINGS_LPIPS_WEIGHTS`` or ``weights_path``: an ``.npz`` with
   torchvision VGG16 ``features`` conv kernels (``conv{i}_w/b``, OIHW) and
   LPIPS linear heads (``lin{0..4}_w``), as ``scripts/export_lpips_weights.py``
   writes; the value is labelled ``lpips``.
2. Otherwise a randomly initialised VGG (He-normal kernels from a
   ``torch.Generator`` seeded with 0, uniform heads), labelled
   ``lpips_rand``. The JAX package draws its random VGG from
   ``jax.random``, which torch cannot reproduce, so the two packages'
   ``lpips_rand`` values differ unless the JAX weights are carried over
   with ``lpips_weights_from_jax``.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pings_tpu_torch import resolve_device

# VGG16 conv plan: (out_channels, pool_before)
_VGG_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
# indices (into the conv list) after whose ReLU LPIPS taps features
_TAPS = (1, 3, 6, 9, 12)

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# (weights by name, calibrated): calibrated is True for real LPIPS weights
LpipsWeights = Tuple[Dict[str, torch.Tensor], bool]


def _random_weights() -> Dict[str, torch.Tensor]:
    """He-initialised VGG16 + uniform linear heads (deterministic)."""
    gen = torch.Generator().manual_seed(0)
    w = {}
    cin = 3
    for i, (cout, _) in enumerate(_VGG_PLAN):
        fan_in = cin * 9
        w[f"conv{i}_w"] = torch.randn((cout, cin, 3, 3), generator=gen) \
            * float(np.sqrt(2.0 / fan_in))
        w[f"conv{i}_b"] = torch.zeros(cout)
        cin = cout
    for j, t in enumerate(_TAPS):
        cout = _VGG_PLAN[t][0]
        w[f"lin{j}_w"] = torch.full((cout,), 1.0 / cout)
    return w


def lpips_weights_from_jax(weights: Mapping[str, np.ndarray],
                           calibrated: bool = False) -> LpipsWeights:
    """The port's weights from the JAX package's (a dict of numpy arrays in
    its npz layout, such as ``pings_tpu.eval.lpips._load_weights(None)[0]``).
    """
    return ({k: torch.tensor(np.asarray(v, np.float32))
             for k, v in weights.items()}, calibrated)


def _to(weights: LpipsWeights, dev: torch.device) -> LpipsWeights:
    return {k: v.to(dev) for k, v in weights[0].items()}, weights[1]


@functools.lru_cache(maxsize=4)
def _load_weights(path: Optional[str], dev: torch.device) -> LpipsWeights:
    if path and os.path.exists(path):
        with np.load(path) as data:
            w = lpips_weights_from_jax({k: data[k] for k in data.files},
                                       calibrated=True)
    else:
        w = _random_weights(), False
    return _to(w, dev)


def load_weights(weights_path: Optional[str] = None,
                 device: str | torch.device = "cuda") -> LpipsWeights:
    """``weights_path``, else ``PINGS_LPIPS_WEIGHTS``, else the random
    VGG; on ``device`` (kept there for the next call)."""
    return _load_weights(weights_path or os.environ.get("PINGS_LPIPS_WEIGHTS"),
                         resolve_device(device))


def _features(x: torch.Tensor, w: Dict[str, torch.Tensor]
              ) -> List[torch.Tensor]:
    """x: (H, W, 3) in [0, 1] -> the tapped feature maps (1, C, h, w)."""
    shift = torch.as_tensor(_SHIFT, device=x.device)
    scale = torch.as_tensor(_SCALE, device=x.device)
    h = ((2.0 * x - 1.0 - shift) / scale).permute(2, 0, 1)[None]
    feats = []
    for i, (_, pool) in enumerate(_VGG_PLAN):
        if pool:
            h = F.max_pool2d(h, 2, 2)
        h = F.conv2d(h, w[f"conv{i}_w"], w[f"conv{i}_b"], padding=1)
        h = torch.relu(h)
        if i in _TAPS:
            feats.append(h)
    return feats


@torch.no_grad()
def lpips(pred, target, weights_path: Optional[str] = None,
          weights: Optional[LpipsWeights] = None,
          device: str | torch.device = "cuda") -> Tuple[float, bool]:
    """Perceptual distance between two (H, W, 3) images in [0, 1] (numpy
    arrays or tensors). Returns (value, calibrated): calibrated is True
    when real LPIPS weights were used. ``weights`` overrides the lookup."""
    dev = resolve_device(device)
    w, calibrated = (_to(weights, dev) if weights is not None
                     else load_weights(weights_path, dev))
    a = torch.as_tensor(pred, dtype=torch.float32, device=dev)
    b = torch.as_tensor(target, dtype=torch.float32, device=dev)
    total = torch.zeros((), device=dev)
    for j, (xa, xb) in enumerate(zip(_features(a, w), _features(b, w))):
        na = xa / torch.sqrt(torch.sum(xa * xa, 1, keepdim=True) + 1e-10)
        nb = xb / torch.sqrt(torch.sum(xb * xb, 1, keepdim=True) + 1e-10)
        lw = w[f"lin{j}_w"][None, :, None, None]
        total = total + torch.mean(torch.sum((na - nb) ** 2 * lw, dim=1))
    return float(total), calibrated
