"""Image / novel-view-synthesis metrics.

Counterpart of ``pings_tpu/eval/image.py`` (``image_metrics`` :23): PSNR
(``mapping/losses.psnr``), SSIM (``ops/ssim``), optionally LPIPS
(``eval/lpips``: ``lpips`` with real weights, ``lpips_rand`` with the
random VGG) and the depth L1 / RMSE over pixels with a target depth.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.eval.lpips import LpipsWeights, lpips
from pings_tpu_torch.mapping.losses import psnr as _psnr
from pings_tpu_torch.ops.ssim import ssim as _ssim


@torch.no_grad()
def image_metrics(pred, target,
                  pred_depth: Optional[np.ndarray] = None,
                  target_depth: Optional[np.ndarray] = None,
                  with_lpips: bool = False,
                  lpips_weights: Optional[LpipsWeights] = None,
                  device: str | torch.device = "cuda",
                  ) -> Dict[str, float]:
    """``pred`` and ``target``: (H, W, 3) in [0, 1], numpy arrays or
    tensors; the metrics are computed on ``device``. ``lpips_weights``
    replaces LPIPS's weight lookup (``eval.lpips.lpips_weights_from_jax``
    carries the JAX package's)."""
    dev = resolve_device(device)
    p = torch.as_tensor(pred, dtype=torch.float32, device=dev)
    t = torch.as_tensor(target, dtype=torch.float32, device=dev)
    out = {
        "psnr": float(_psnr(p, t)),
        "ssim": float(_ssim(p, t)),
    }
    if with_lpips:
        v, calibrated = lpips(p, t, weights=lpips_weights, device=dev)
        out["lpips" if calibrated else "lpips_rand"] = v
    if pred_depth is not None and target_depth is not None:
        m = target_depth > 1e-4
        if m.any():
            diff = np.abs(pred_depth - target_depth)[m]
            out["depth_l1_m"] = float(diff.mean())
            out["depth_rmse_m"] = float(np.sqrt((diff**2).mean()))
        else:
            out["depth_l1_m"] = float("nan")
            out["depth_rmse_m"] = float("nan")
    return out
