"""The benchmark's sensors: a spinning LiDAR, a pinhole camera and an
RGB-D camera, ray-cast on the device against a ``world.World``.

Frozen copies of ``kitti_scan``, ``render_pinhole``, ``kitti_lidar_dirs``
and ``kitti_poses`` of ``pings_tpu_torch/data/synthetic.py``, of
``replica_pose`` of ``scripts/torch_make_replica_data.py`` and of the
replica loader's ``backproject`` (stride 2 above 400,000 pixels), with the
sensors' sizes taken from the configuration's ``sensor`` entry instead of
constants. A frame is the dict ``SlamSystem.process_frame`` takes, with
numpy arrays on the host, as a live sensor hands them over.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.gen.world import circuit_path


def _skew(w) -> np.ndarray:
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])


def so3_exp(w) -> np.ndarray:
    """Rodrigues' formula in float64."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3) + _skew(w)
    K = _skew(w / th)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def se3_inv(T: np.ndarray) -> np.ndarray:
    R, t = T[:3, :3], T[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def kitti_poses(n_frames: int, step_m: float = 1.2, height: float = 1.6):
    """Ground-truth body poses (4x4, float64) along the circuit."""
    pos2d, yaws = circuit_path(n_frames, step=step_m)
    poses = []
    for i in range(n_frames):
        T = np.eye(4)
        T[:3, :3] = so3_exp([0, 0, yaws[i]])
        T[:3, 3] = [pos2d[i, 0], pos2d[i, 1], height]
        poses.append(T)
    return poses


def orbit_pose(i: int, n_poses: int) -> np.ndarray:
    """Camera-to-world pose ``i`` of the room's ``n_poses``-frame orbit."""
    ang = 2 * np.pi * i / max(n_poses, 1) * 0.75
    eye = np.array([1.8 * np.cos(ang), 1.5 * np.sin(ang), 1.4])
    yaw = ang + np.pi / 2 * 0.6 + 0.3 * np.sin(2 * ang)
    R_wc = so3_exp([0, 0, yaw]) @ so3_exp([0.12, 0, 0]) @ \
        np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    T = np.eye(4)
    T[:3, :3] = R_wc
    T[:3, 3] = eye
    return T


def lidar_dirs(beams: int, azimuths: int, el_min_deg: float,
               el_max_deg: float) -> np.ndarray:
    """Unit beam directions in the sensor frame, (beams * azimuths, 3),
    elevation-major."""
    el = np.radians(np.linspace(el_min_deg, el_max_deg, beams))
    az = np.linspace(-np.pi, np.pi, azimuths, endpoint=False)
    AZ, EL = np.meshgrid(az, el)
    return np.stack([np.cos(EL) * np.cos(AZ), np.cos(EL) * np.sin(AZ),
                     np.sin(EL)], -1).reshape(-1, 3)


def lidar_scan(world, T: np.ndarray, dirs_l: torch.Tensor, noise_m: float,
               gen: torch.Generator | None, r_min: float, r_max: float
               ) -> np.ndarray:
    """One sweep from body pose ``T``: (M, 3) float32 points in the
    sensor frame with Gaussian range noise of ``noise_m`` drawn from
    ``gen``, returns kept where r_min < range < r_max."""
    dev = dirs_l.device
    Tt = torch.as_tensor(T, dtype=torch.float64, device=dev)
    dirs_w = dirs_l @ Tt[:3, :3].T
    origins = Tt[:3, 3].expand(dirs_w.shape[0], 3)
    t, hit, _ = world.cast(origins, dirs_w)
    if noise_m > 0:
        t = t + torch.randn(t.shape, dtype=torch.float64, device=dev,
                            generator=gen) * noise_m * hit
    keep = hit & (t < r_max) & (t > r_min)
    return (dirs_l[keep] * t[keep, None]).to(torch.float32).cpu().numpy()


def pinhole(world, T_w_c: np.ndarray, K: np.ndarray, width: int,
            height: int):
    """Ray-cast an (H, W, 3) uint8 image and an (H, W) float32 z-depth
    (0 where nothing is hit), both on the device."""
    dev = world.device
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float64,
                                         device=dev),
                            torch.arange(width, dtype=torch.float64,
                                         device=dev), indexing="ij")
    dc = torch.stack([(xs + 0.5 - K[0, 2]) / K[0, 0],
                      (ys + 0.5 - K[1, 2]) / K[1, 1],
                      torch.ones_like(xs)], -1).reshape(-1, 3)
    dcn = dc / torch.linalg.norm(dc, dim=1, keepdim=True)
    Tt = torch.as_tensor(T_w_c, dtype=torch.float64, device=dev)
    dw = dcn @ Tt[:3, :3].T
    t, hit, col = world.cast(Tt[:3, 3].expand(dw.shape[0], 3), dw)
    img = (torch.clamp(col, 0, 1) * 255).to(torch.uint8).reshape(
        height, width, 3)
    z = (t * dcn[:, 2]).reshape(height, width)
    depth = torch.where(hit.reshape(height, width), z,
                        torch.zeros_like(z)).to(torch.float32)
    return img, depth


def add_image_noise(img: torch.Tensor, sigma: float,
                    gen: torch.Generator | None) -> torch.Tensor:
    """uint8 image plus Gaussian noise of ``sigma`` (in [0, 1] units),
    rounded and clipped."""
    if sigma <= 0:
        return img
    n = torch.randn(img.shape, device=img.device, generator=gen) * (
        sigma * 255.0)
    return torch.clamp(torch.round(img.to(torch.float32) + n), 0,
                       255).to(torch.uint8)


def backproject(depth: torch.Tensor, K: np.ndarray, rgb: torch.Tensor,
                stride: int):
    """(M, 6) float32 camera-frame points with their [0, 1] colours, every
    ``stride``-th pixel whose depth is above 1e-4 m."""
    h, w = depth.shape
    dev = depth.device
    iy, ix = torch.meshgrid(torch.arange(0, h, stride, device=dev),
                            torch.arange(0, w, stride, device=dev),
                            indexing="ij")
    ys, xs = iy.to(torch.float64), ix.to(torch.float64)
    d = depth[::stride, ::stride]
    ok = d > 1e-4
    d = d.to(torch.float64)
    x = (xs + 0.5 - K[0, 2]) / K[0, 0] * d
    y = (ys + 0.5 - K[1, 2]) / K[1, 1] * d
    pts = torch.stack([x[ok], y[ok], d[ok]], -1).to(torch.float32)
    col = rgb[iy[ok], ix[ok]].to(torch.float32) / 255.0
    return torch.cat([pts, col], 1).cpu().numpy()
