"""Procedural synthetic LiDAR + camera data (numpy only).

A copy of what makes the sensor data of the committed validation runs, so
that the port can train on the real scenes without the JAX package:
``_ray_scene`` and ``default_world`` of ``pings_tpu/data/synthetic.py``
(:18-125), and of ``scripts/make_validation_data.py`` ``room_world`` (:37),
``render_pinhole`` (:63), ``circuit_path`` (:158), ``circuit_world``
(:200), ``_circuit_point`` (:238) and the camera and LiDAR set-up of
``make_kitti`` (:253-318, here ``kitti_rig``, ``kitti_poses``,
``kitti_scan`` and ``kitti_frame``). Worlds are lists of analytic
primitives (planes, boxes, spheres, a room shell) that are ray-cast.
"""

from __future__ import annotations

import numpy as np


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues: axis-angle (3,) -> rotation matrix (float64)."""
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    k = w / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def se3_inv(T: np.ndarray) -> np.ndarray:
    R, t = T[:3, :3], T[:3, 3]
    Ti = np.eye(4)
    Ti[:3, :3] = R.T
    Ti[:3, 3] = -R.T @ t
    return Ti


def _ray_scene(origins: np.ndarray, dirs: np.ndarray, objects):
    """Batch ray casting. Returns (t, hit, color (N,3))."""
    n = len(dirs)
    t_best = np.full(n, np.inf)
    color = np.zeros((n, 3), np.float32)
    for obj in objects:
        kind = obj["kind"]
        if kind == "plane":
            # z = height plane
            h = obj["z"]
            dz = dirs[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (h - origins[:, 2]) / dz
            ok = (np.abs(dz) > 1e-6) & (t > 0.05)
            p = origins + dirs * t[:, None]
            if obj.get("texture") == "smooth":
                # low-frequency colour field instead of the 1 m checker
                s = 0.5 + 0.5 * np.sin(0.9 * p[:, 0]) * np.sin(1.3 * p[:, 1])
                c = (obj["color1"] * s[:, None]
                     + obj["color2"] * (1.0 - s[:, None]))
            else:
                checker = ((np.floor(p[:, 0]) + np.floor(p[:, 1]))
                           % 2).astype(bool)
                c = np.where(checker[:, None], obj["color1"], obj["color2"])
        elif kind == "sphere":
            oc = origins - obj["center"]
            b = np.sum(dirs * oc, axis=1)
            cc = np.sum(oc * oc, axis=1) - obj["radius"] ** 2
            disc = b * b - cc
            ok = disc > 0
            t = -b - np.sqrt(np.maximum(disc, 0))
            ok &= t > 0.05
            p = origins + dirs * t[:, None]
            nrm = (p - obj["center"]) / obj["radius"]
            c = 0.5 + 0.4 * nrm * obj.get("tint", 1.0)
        elif kind == "box":
            lo = obj["min"][None]
            hi = obj["max"][None]
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = 1.0 / dirs
            t0 = (lo - origins) * inv
            t1 = (hi - origins) * inv
            tmin = np.minimum(t0, t1).max(axis=1)
            tmax = np.maximum(t0, t1).min(axis=1)
            ok = (tmax > tmin) & (tmin > 0.05)
            t = tmin
            c = np.tile(obj["color"], (n, 1))
        elif kind == "box_inner":
            # inside-out AABB: the room shell. Hit = exit point (tmax);
            # walls get a 1 m checker so photometric training has texture.
            lo = obj["min"][None]
            hi = obj["max"][None]
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = 1.0 / dirs
            t0 = (lo - origins) * inv
            t1 = (hi - origins) * inv
            tmax = np.maximum(t0, t1).min(axis=1)
            ok = tmax > 0.05
            t = tmax
            p = origins + dirs * t[:, None]
            if obj.get("texture") == "smooth":
                s = (0.5 + 0.5 * np.sin(0.8 * p[:, 0])
                     * np.sin(1.1 * p[:, 1]) * np.cos(0.7 * p[:, 2]))
                c = (obj["color1"] * s[:, None]
                     + obj["color2"] * (1.0 - s[:, None]))
            else:
                checker = ((np.floor(p[:, 0]) + np.floor(p[:, 1])
                            + np.floor(p[:, 2])) % 2).astype(bool)
                c = np.where(checker[:, None], obj["color1"], obj["color2"])
            # tint each wall pair differently so the room is not ambiguous
            axis = np.argmin(np.stack([
                np.minimum(np.abs(p[:, i] - lo[0, i]),
                           np.abs(p[:, i] - hi[0, i])) for i in range(3)
            ], 1), axis=1)
            tintmap = np.array([[1.0, 0.85, 0.8], [0.8, 1.0, 0.85],
                                [0.85, 0.8, 1.0]], np.float32)
            c = c * tintmap[axis]
        else:
            continue
        better = ok & (t < t_best)
        t_best = np.where(better, t, t_best)
        color = np.where(better[:, None], c.astype(np.float32), color)
    hit = np.isfinite(t_best)
    return np.where(hit, t_best, 0.0), hit, color


def default_world():
    return [
        {"kind": "plane", "z": 0.0,
         "color1": np.array([0.55, 0.5, 0.45], np.float32),
         "color2": np.array([0.35, 0.35, 0.4], np.float32)},
        {"kind": "box", "min": np.array([4.0, -6.0, 0.0]),
         "max": np.array([6.0, -4.0, 2.5]),
         "color": np.array([0.8, 0.25, 0.2], np.float32)},
        {"kind": "box", "min": np.array([8.0, 3.0, 0.0]),
         "max": np.array([10.5, 5.5, 3.5]),
         "color": np.array([0.2, 0.5, 0.8], np.float32)},
        {"kind": "sphere", "center": np.array([12.0, -2.0, 1.5]),
         "radius": 1.5, "tint": 1.0},
        {"kind": "box", "min": np.array([-6.0, -8.0, 0.0]),
         "max": np.array([-4.0, 8.0, 4.0]),
         "color": np.array([0.7, 0.65, 0.3], np.float32)},
        {"kind": "sphere", "center": np.array([0.0, 8.0, 2.0]),
         "radius": 2.0, "tint": -1.0},
    ]


def room_world(texture: str = "checker"):
    """Indoor world: a 10x8x3 m room shell with furniture-scale boxes
    and spheres. texture="smooth" replaces the hard 1 m checkers with
    low-frequency colour fields."""
    return [
        {"kind": "box_inner", "min": np.array([-5.0, -4.0, 0.0]),
         "max": np.array([5.0, 4.0, 3.0]),
         "color1": np.array([0.75, 0.72, 0.65], np.float32),
         "color2": np.array([0.45, 0.47, 0.52], np.float32),
         "texture": texture},
        {"kind": "box", "min": np.array([1.5, -3.2, 0.0]),
         "max": np.array([3.5, -1.8, 0.9]),
         "color": np.array([0.6, 0.3, 0.2], np.float32)},
        {"kind": "box", "min": np.array([-3.5, 1.5, 0.0]),
         "max": np.array([-1.5, 3.4, 1.4]),
         "color": np.array([0.25, 0.45, 0.65], np.float32)},
        {"kind": "sphere", "center": np.array([0.0, -2.0, 0.6]),
         "radius": 0.6, "tint": 1.0},
        {"kind": "sphere", "center": np.array([-2.5, -2.5, 1.8]),
         "radius": 0.45, "tint": -1.0},
        {"kind": "box", "min": np.array([3.6, 1.8, 0.0]),
         "max": np.array([4.6, 3.6, 2.2]),
         "color": np.array([0.7, 0.65, 0.3], np.float32)},
    ]


def render_pinhole(T_w_c, K, width, height, objects):
    """Ray-cast an RGB + z-depth image for a camera-to-world pose."""
    ys, xs = np.mgrid[0:height, 0:width]
    dc = np.stack([
        (xs + 0.5 - K[0, 2]) / K[0, 0],
        (ys + 0.5 - K[1, 2]) / K[1, 1],
        np.ones_like(xs, np.float64),
    ], -1).reshape(-1, 3)
    dcn = dc / np.linalg.norm(dc, axis=1, keepdims=True)
    dw = dcn @ T_w_c[:3, :3].T
    co = np.tile(T_w_c[:3, 3], (len(dw), 1))
    t, hit, col = _ray_scene(co, dw, objects)
    img = (np.clip(col, 0, 1) * 255).astype(np.uint8).reshape(
        height, width, 3)
    z = (t * dcn[:, 2]).reshape(height, width)
    depth = np.where(hit.reshape(height, width), z, 0.0).astype(np.float32)
    return img, depth


def circuit_path(n_frames: int, step: float = 1.2, A: float = 80.0,
                 R: float = 15.0, ramp_frames: int = 30):
    """Closed stadium circuit (two straights of length A joined by
    semicircular turns of radius R): total length 2A + 2*pi*R (about 254 m
    with the defaults). Returns (positions (N, 2), yaws (N,)). The vehicle
    accelerates from rest over ``ramp_frames``."""
    total = 2.0 * A + 2.0 * np.pi * R
    speed = step * np.minimum(
        1.0, np.arange(n_frames) / max(ramp_frames, 1))
    s = np.concatenate([[0.0], np.cumsum(speed)[:-1]]) % total
    pos = np.zeros((n_frames, 2))
    yaw = np.zeros(n_frames)
    for i, si in enumerate(s):
        if si < A:                                   # straight +x at y=0
            pos[i] = [si, 0.0]
            yaw[i] = 0.0
        elif si < A + np.pi * R:                     # left turn at x=A
            a = (si - A) / R
            pos[i] = [A + R * np.sin(a), R - R * np.cos(a)]
            yaw[i] = a
        elif si < 2 * A + np.pi * R:                 # straight -x at y=2R
            pos[i] = [A - (si - A - np.pi * R), 2 * R]
            yaw[i] = np.pi
        else:                                        # left turn at x=0
            a = (si - 2 * A - np.pi * R) / R
            pos[i] = [-R * np.sin(a), R + R * np.cos(a)]
            yaw[i] = np.pi + a
    return pos, yaw


def circuit_world(A: float = 80.0, R: float = 15.0, seed: int = 4):
    """Buildings (AABBs) + spheres scattered along BOTH sides of the
    stadium circuit, corridor (path +-5.5 m) kept clear; ground plane."""
    rng = np.random.default_rng(seed)
    objs = [{"kind": "plane", "z": 0.0,
             "color1": np.array([0.55, 0.5, 0.45], np.float32),
             "color2": np.array([0.35, 0.35, 0.4], np.float32)}]
    # dense sampling along the path; boxes at lateral offsets both sides
    total = 2.0 * A + 2.0 * np.pi * R
    s = 0.0
    while s < total:
        p, y = _circuit_point(s, A, R)
        n_hat = np.array([-np.sin(y), np.cos(y)])     # left normal
        for side in (-1.0, 1.0):
            if rng.random() < 0.92:
                d = rng.uniform(7.5, 12.0)
                c = p + side * d * n_hat
                hw = rng.uniform(0.8, 2.0)
                hd = rng.uniform(0.8, 2.0)
                h = rng.uniform(2.0, 5.5)
                objs.append({
                    "kind": "box",
                    "min": np.array([c[0] - hw, c[1] - hd, 0.0]),
                    "max": np.array([c[0] + hw, c[1] + hd, h]),
                    "color": rng.uniform(0.2, 0.85, 3).astype(np.float32),
                })
        if rng.random() < 0.35:
            side = float(rng.choice([-1.0, 1.0]))
            c = p + side * rng.uniform(6.0, 8.0) * n_hat
            objs.append({
                "kind": "sphere",
                "center": np.array([c[0], c[1], 0.8]),
                "radius": rng.uniform(0.5, 1.1),
                "tint": float(rng.choice([-1.0, 1.0]))})
        s += rng.uniform(4.0, 6.5)
    return objs


def _circuit_point(s: float, A: float, R: float):
    """(x, y), yaw at arc length s of the stadium circuit."""
    total = 2.0 * A + 2.0 * np.pi * R
    s = s % total
    if s < A:
        return np.array([s, 0.0]), 0.0
    if s < A + np.pi * R:
        a = (s - A) / R
        return np.array([A + R * np.sin(a), R - R * np.cos(a)]), a
    if s < 2 * A + np.pi * R:
        return np.array([A - (s - A - np.pi * R), 2 * R]), np.pi
    a = (s - 2 * A - np.pi * R) / R
    return np.array([-R * np.sin(a), R + R * np.cos(a)]), np.pi + a


def kitti_rig():
    """(T_c_l, K, width, height) of the synthetic kitti sequence. Body and
    LiDAR frame: x forward, z up; camera: x right, y down, z forward."""
    T_c_l = np.eye(4)
    T_c_l[:3, :3] = np.array([[0.0, -1, 0], [0, 0, -1], [1, 0, 0]])
    T_c_l[:3, 3] = [0.05, -0.1, -0.3]
    K = np.array([[420.0, 0, 320.0], [0, 420.0, 120.0], [0, 0, 1.0]])
    return T_c_l, K, 640, 240


def kitti_poses(n_frames: int, step_m: float = 1.2):
    """Ground-truth body poses (4x4, float64) along the closed circuit."""
    pos2d, yaws = circuit_path(n_frames, step=step_m)
    poses = []
    for i in range(n_frames):
        T = np.eye(4)
        T[:3, :3] = so3_exp(np.array([0, 0, yaws[i]]))
        T[:3, 3] = [pos2d[i, 0], pos2d[i, 1], 1.6]
        poses.append(T)
    return poses


def kitti_lidar_dirs() -> np.ndarray:
    """Unit beam directions of the 64-beam, 1024-azimuth spinning LiDAR in
    the sensor frame, (65536, 3)."""
    el = np.radians(np.linspace(-24.8, 2.0, 64))
    az = np.linspace(-np.pi, np.pi, 1024, endpoint=False)
    AZ, EL = np.meshgrid(az, el)
    return np.stack([np.cos(EL) * np.cos(AZ), np.cos(EL) * np.sin(AZ),
                     np.sin(EL)], -1).reshape(-1, 3)


def kitti_scan(T: np.ndarray, objects, rng: np.random.Generator,
               dirs_l: np.ndarray | None = None) -> np.ndarray:
    """One LiDAR scan from body pose ``T``: (M, 3) float32 points in the
    sensor frame, range noise of 8 mm drawn from ``rng``, returns kept
    between 1.5 m and 80 m."""
    if dirs_l is None:
        dirs_l = kitti_lidar_dirs()
    dirs_w = dirs_l @ T[:3, :3].T
    origins = np.tile(T[:3, 3], (len(dirs_w), 1))
    t, hit, _ = _ray_scene(origins, dirs_w, objects)
    t = t + rng.normal(0, 0.008, len(t)) * hit
    keep = hit & (t < 80.0) & (t > 1.5)
    return (dirs_l[keep] * t[keep, None]).astype(np.float32)


def kitti_frame(T: np.ndarray, objects):
    """The camera's (uint8 image, float32 z-depth, float32 sky mask) from
    body pose ``T``. The depth is 0 and the sky mask 1 where no surface is
    hit."""
    T_c_l, K, W, H = kitti_rig()
    img, depth = render_pinhole(T @ se3_inv(T_c_l), K, W, H, objects)
    return img, depth, (depth <= 0).astype(np.float32)
