"""Monocular depth/sky priors with LiDAR alignment.

Counterpart of the reference's optional Metric3D path
(dataset/slam_dataset.py:135-143 model load, :333-480 inference +
LiDAR least-squares depth alignment + sky-mask inference), used on
camera-dominant sequences (e.g. KITTI) to densify supervision where the
LiDAR is sparse.

Design: the *model* is pluggable (``DepthProvider``) because pretrained
weights may be unavailable in an air-gapped TPU pod; the *math* —
robust scale/shift alignment of a relative depth map onto projected
LiDAR returns, and sky extraction — is self-contained numpy and always
available. A provider only has to map an RGB uint8 image to a raw
(H, W) float depth/disparity map.

A copy of ``pings_tpu/data/monodepth.py``: the port imports nothing of the JAX
package. The ``"dpt"`` provider loads its weights with ``local_files_only``: a
machine without the weights gets None and never reaches the network.
"""

from __future__ import annotations

from typing import Optional, Protocol, Tuple

import numpy as np


class DepthProvider(Protocol):
    def __call__(self, rgb_u8: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 -> (H, W) float raw depth (any affine scale)."""
        ...


def make_provider(name: str) -> Optional[DepthProvider]:
    """Resolve a named provider; returns None when its weights/deps are
    absent (callers must degrade gracefully — mono priors are optional)."""
    if name in ("", "none", None):
        return None
    if name == "dpt":
        try:  # transformers' DPT/ZoeDepth-style models (torch CPU)
            import torch
            from transformers import (AutoImageProcessor,
                                      DPTForDepthEstimation)
            # only weights already on disk: never a download
            proc = AutoImageProcessor.from_pretrained(
                "Intel/dpt-large", local_files_only=True)
            model = DPTForDepthEstimation.from_pretrained(
                "Intel/dpt-large", local_files_only=True)
            model.eval()

            def run(rgb_u8: np.ndarray) -> np.ndarray:
                with torch.no_grad():
                    inp = proc(images=rgb_u8, return_tensors="pt")
                    d = model(**inp).predicted_depth[0].numpy()
                # DPT predicts relative inverse depth; invert to depth-ish
                return 1.0 / np.maximum(d, 1e-6)

            return run
        except Exception:
            return None
    raise ValueError(f"unknown mono depth provider: {name}")


def align_depth_to_lidar(
    mono: np.ndarray,            # (H, W) raw mono depth
    lidar_depth: np.ndarray,     # (H, W) metric depth, 0 = no return
    max_depth: float = 80.0,
    trim: float = 0.2,
    min_points: int = 50,
) -> Tuple[Optional[np.ndarray], float, float]:
    """Fit metric = a * mono + b on LiDAR-covered pixels (trimmed LS).

    Mirrors the reference's per-frame least-squares alignment
    (slam_dataset.py:414-449): one robust affine fit per image, with the
    worst ``trim`` fraction of residuals dropped once and the fit redone.
    Returns (aligned (H, W) or None if underdetermined, a, b)."""
    valid = (lidar_depth > 1e-3) & (lidar_depth < max_depth) \
        & np.isfinite(mono)
    if valid.sum() < min_points:
        return None, 1.0, 0.0
    x = mono[valid].astype(np.float64)
    y = lidar_depth[valid].astype(np.float64)

    def fit(x, y):
        A = np.stack([x, np.ones_like(x)], 1)
        sol, *_ = np.linalg.lstsq(A, y, rcond=None)
        return sol

    a, b = fit(x, y)
    r = np.abs(a * x + b - y)
    keep = r <= np.quantile(r, 1.0 - trim)
    if keep.sum() >= min_points:
        a, b = fit(x[keep], y[keep])
    if not np.isfinite(a) or a <= 0:
        return None, 1.0, 0.0
    aligned = np.clip(a * mono + b, 0.0, max_depth).astype(np.float32)
    return aligned, float(a), float(b)


def sky_mask_from_depth(mono: np.ndarray,
                        far_quantile: float = 0.95,
                        rel_thresh: float = 0.98) -> np.ndarray:
    """Sky = pixels at the far plateau of the raw mono depth map
    (reference sky-mask inference, slam_dataset.py:452-462). Returns
    (H, W) bool."""
    far = np.quantile(mono[np.isfinite(mono)], far_quantile)
    return (mono >= rel_thresh * far) & np.isfinite(mono)


def densify_depth(
    rgb_u8: np.ndarray,
    lidar_depth: np.ndarray,
    provider: DepthProvider,
    max_depth: float = 80.0,
    keep_lidar: bool = True,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Full prior pipeline for one camera frame: infer -> align -> merge.

    Returns (dense_depth (H, W) f32, sky (H, W) bool or None). Where
    LiDAR returns exist they win (keep_lidar); mono fills the holes."""
    mono = provider(rgb_u8)
    if mono.shape != lidar_depth.shape:
        # nearest-neighbor resize without external deps
        h, w = lidar_depth.shape
        yi = (np.arange(h) * mono.shape[0] / h).astype(int)
        xi = (np.arange(w) * mono.shape[1] / w).astype(int)
        mono = mono[yi][:, xi]
    aligned, a, b = align_depth_to_lidar(mono, lidar_depth, max_depth)
    sky = sky_mask_from_depth(mono)
    if aligned is None:
        return lidar_depth.astype(np.float32), sky
    dense = aligned.copy()
    dense[sky] = 0.0
    if keep_lidar:
        has = lidar_depth > 1e-3
        dense[has] = lidar_depth[has]
    return dense, sky
