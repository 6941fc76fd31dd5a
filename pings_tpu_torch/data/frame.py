"""Per-frame preprocessing: crop, deskew, downsample, camera projection.

Counterpart of ``pings_tpu/data/frame.py``: ``pad_pow2`` (:26-36), the
``PreprocessedFrame`` record (:38), ``preprocess_frame`` (:53-134, with
the deskew :68-84 and random downsampling :85-91),
``project_scan_to_cam`` (:137) and ``colorize_scan`` (:149-160). The crop,
the deskew and the two voxel downsamples run on ``device`` and their
results come back as numpy arrays, as in the JAX package; the camera
projections run on ``device`` and return tensors there. Every function
defaults to "cuda" and raises without a card.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pings_tpu_torch import resolve_device
from pings_tpu_torch.ops import transforms as tf
from pings_tpu_torch.utils import trace


def pad_pow2(pts: np.ndarray, min_size: int = 4096):
    """Pad to the next power-of-two length; returns (padded, mask)."""
    n = len(pts)
    size = max(min_size, 1 << int(np.ceil(np.log2(max(n, 1)))))
    out = np.zeros((size,) + pts.shape[1:], pts.dtype)
    out[:n] = pts
    mask = np.zeros(size, bool)
    mask[:n] = True
    return out, mask


class PreprocessedFrame:
    def __init__(self):
        self.points_l: np.ndarray = None       # (P, 3) padded, sensor frame
        self.colors: np.ndarray = None         # (P, 3)
        self.mask: np.ndarray = None           # (P,)
        self.point_ts: Optional[np.ndarray] = None
        self.sem: Optional[np.ndarray] = None  # (P,) i32 class ids; -1 = none
        self.source_points: np.ndarray = None  # (S, 3) tracker source
        self.source_mask: np.ndarray = None
        self.source_intensity: np.ndarray = None  # (S,) [0,1]; -1 = none
        self.cams: Dict[str, dict] = {}
        self.gt_pose: Optional[np.ndarray] = None
        self.raw: dict = None


def preprocess_frame(frame: dict, cfg, T_rel_last: np.ndarray,
                     deskew_on: bool,
                     device: str | torch.device = "cuda"
                     ) -> PreprocessedFrame:
    """Crop, deskew and downsample a frame's scan: the map input at
    ``vox_down_m`` (or a random share ``rand_down_r`` with
    ``rand_downsample``) and the tracker's source points at
    ``source_vox_down_m`` (at most ``source_max_count``, thinned by a
    stride), padded to powers of two; the cameras' data passed through.
    With ``deskew_on`` and per-point times, each point is moved by the
    share of ``T_rel_last`` (the last frame's relative motion) that its
    time leaves to the end of the sweep; the times are normalized per
    sensor where the frame has ``point_lidar_idx``."""
    device = resolve_device(device)
    out = PreprocessedFrame()
    out.raw = frame
    pts = np.asarray(frame["points"], np.float32)
    colors = pts[:, 3:6] if pts.shape[1] >= 6 else np.zeros_like(pts[:, :3])
    pts = pts[:, :3]
    ts = frame.get("point_ts")

    pts_p, mask = pad_pow2(pts)
    colors_p, _ = pad_pow2(colors)
    with trace.read("scan_upload", n=2):
        tp = torch.as_tensor(pts_p, device=device)
        tm = torch.as_tensor(mask, device=device)
    tm = tm & tf.crop_range_mask(tp, cfg.min_range, cfg.max_range,
                                 cfg.min_z, cfg.max_z)
    if deskew_on and ts is not None and len(ts):
        ts_np = np.asarray(ts, np.float32).copy()
        lidar_idx = frame.get("point_lidar_idx")
        if lidar_idx is not None and len(lidar_idx):
            # several LiDARs, each sweeping on its own clock: normalize
            # the times per sensor, so that one slerp of the relative
            # motion compensates all of them
            li = np.asarray(lidar_idx).reshape(-1)
            for s_id in np.unique(li):
                sel = li == s_id
                t0, t1 = ts_np[sel].min(), ts_np[sel].max()
                if t1 > t0:
                    ts_np[sel] = (ts_np[sel] - t0) / (t1 - t0)
        ts_p, _ = pad_pow2(ts_np)
        with trace.read("deskew_upload", n=2):
            ts_t = torch.as_tensor(ts_p, device=device)
            T_t = torch.as_tensor(np.asarray(T_rel_last, np.float32),
                                  device=device)
        tp = tf.deskew(tp, ts_t, T_t)
    if cfg.rand_downsample:
        # keep each point with probability rand_down_r (a host generator,
        # seeded as in the JAX package)
        rng_ds = np.random.default_rng(cfg.seed + pts.shape[0])
        with trace.read("rand_down_upload"):
            keep_rand = torch.as_tensor(
                rng_ds.random(tp.shape[0]) < cfg.rand_down_r, device=device)
        keep_map = tm & keep_rand
    else:
        keep_map = tf.voxel_down_sample_mask(tp, tm, cfg.vox_down_m)
    keep_src = tf.voxel_down_sample_mask(tp, tm, cfg.source_vox_down_m)

    with trace.read("scan_download", n=3):
        out.points_l = tp.cpu().numpy()
        out.mask = keep_map.cpu().numpy()
        keep_src = keep_src.cpu().numpy()
    out.colors = colors_p
    out.point_ts = ts
    sem = frame.get("sem")
    if sem is not None and len(sem):
        sem_p, _ = pad_pow2(np.asarray(sem, np.int32).reshape(-1))
        out.sem = sem_p.astype(np.int32)

    src_idx = np.nonzero(keep_src)[0]
    if len(src_idx) > cfg.source_max_count:
        src_idx = src_idx[:: len(src_idx) // cfg.source_max_count + 1]
    src = out.points_l[src_idx]
    out.source_points, out.source_mask = pad_pow2(src, min_size=1024)
    # per-source-point intensity for photometric registration; -1 = no
    # colour measurement
    src_col = out.colors[src_idx]
    inten = np.where(np.any(src_col > 0, axis=-1),
                     src_col.mean(axis=-1), -1.0).astype(np.float32)
    out.source_intensity, _ = pad_pow2(inten, min_size=1024)
    out.source_intensity[~out.source_mask] = -1.0

    for cam in frame.get("img", {}):
        out.cams[cam] = {
            "img": frame["img"][cam],
            "depth": frame.get("depth", {}).get(cam),
            "sky": frame.get("sky", {}).get(cam),
            "K": frame["K"][cam],
            "T_c_l": frame["T_c_l"][cam],
            # fraction of a frame period between this camera's shutter and
            # the LiDAR sweep's reference time; 0 = synchronized
            "ts_frac": frame.get("cam_ts_frac", {}).get(cam, 0.0),
        }
    if "gt_pose" in frame:
        out.gt_pose = np.asarray(frame["gt_pose"], np.float64)
    return out


def _on(a, device) -> torch.Tensor:
    """``a`` (an array or a tensor) on ``device``; a copy from another
    device waits for the card."""
    if isinstance(a, torch.Tensor) and a.device.type == device.type:
        return a.to(device)
    with trace.read("camera_upload"):
        return torch.as_tensor(a, device=device)


def _f32(a, device) -> torch.Tensor:
    return _on(a, device).to(torch.float32)


def project_scan_to_cam(points_w, mask, T_c_w: np.ndarray, K: np.ndarray,
                        width: int, height: int,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """LiDAR depth map (height, width) for a camera (min-depth splat), on
    ``device``; the points and the mask may be arrays or tensors."""
    dev = resolve_device(device)
    uv, z, valid = tf.project_points_to_cam(
        _f32(points_w, dev), _on(mask, dev).bool(),
        _f32(T_c_w, dev), _f32(K, dev), width, height)
    return tf.splat_depth_map(uv, z, valid, width, height)


def colorize_scan(points_w, mask, T_c_w: np.ndarray, K: np.ndarray, image,
                  device: str | torch.device = "cuda"):
    """Image colour at the projected scan points (nearest pixel): (colors
    (N, 3), valid (N,)) on ``device``. The points, the mask and the image
    (H, W, 3), 0-255, may be arrays or tensors; the image goes to the
    device as it is and is scaled there."""
    dev = resolve_device(device)
    h, w = image.shape[:2]
    uv, _, valid = tf.project_points_to_cam(
        _f32(points_w, dev), _on(mask, dev).bool(),
        _f32(T_c_w, dev), _f32(K, dev), w, h)
    return tf.colorize_points(uv, valid, _f32(image, dev) / 255.0)
