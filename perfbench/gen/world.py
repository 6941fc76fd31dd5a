"""The benchmark's frozen copy of the synthetic worlds and their ray caster.

The worlds are those of ``pings_tpu_torch/data/synthetic.py`` (the
stadium circuit of the kitti sequence and the furnished room of the
replica sequence): lists of analytic primitives (a ground plane, boxes,
spheres, an inside-out room shell). ``cast`` ray-casts them with the same
formulas and the same first-hit rule, rewritten in PyTorch so that set-up
builds a window's frames on the card. It works in float64 and returns
``(t, hit, colour)`` as the numpy caster does.
"""

from __future__ import annotations

import numpy as np
import torch

KINDS = ("plane", "box", "sphere", "box_inner")


def circuit_path(n_frames: int, step: float = 1.2, A: float = 80.0,
                 R: float = 15.0, ramp_frames: int = 30):
    """Closed stadium circuit: two straights of length A joined by
    semicircles of radius R, driven from rest over ``ramp_frames``.
    Returns (positions (N, 2), yaws (N,))."""
    total = 2.0 * A + 2.0 * np.pi * R
    speed = step * np.minimum(1.0, np.arange(n_frames) / max(ramp_frames, 1))
    s = np.concatenate([[0.0], np.cumsum(speed)[:-1]]) % total
    pos = np.zeros((n_frames, 2))
    yaw = np.zeros(n_frames)
    for i, si in enumerate(s):
        pos[i], yaw[i] = circuit_point(si, A, R)
    return pos, yaw


def circuit_point(s: float, A: float, R: float):
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


def circuit_world(A: float = 80.0, R: float = 15.0, seed: int = 4):
    """Boxes and spheres along both sides of the circuit (the corridor of
    +-5.5 m kept clear) on a checkered ground plane."""
    rng = np.random.default_rng(seed)
    objs = [{"kind": "plane", "z": 0.0,
             "color1": np.array([0.55, 0.5, 0.45], np.float32),
             "color2": np.array([0.35, 0.35, 0.4], np.float32)}]
    total = 2.0 * A + 2.0 * np.pi * R
    s = 0.0
    while s < total:
        p, y = circuit_point(s, A, R)
        n_hat = np.array([-np.sin(y), np.cos(y)])
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
                    "color": rng.uniform(0.2, 0.85, 3).astype(np.float32)})
        if rng.random() < 0.35:
            side = float(rng.choice([-1.0, 1.0]))
            c = p + side * rng.uniform(6.0, 8.0) * n_hat
            objs.append({
                "kind": "sphere", "center": np.array([c[0], c[1], 0.8]),
                "radius": rng.uniform(0.5, 1.1),
                "tint": float(rng.choice([-1.0, 1.0]))})
        s += rng.uniform(4.0, 6.5)
    return objs


def room_world():
    """A 10 x 8 x 3 m room shell with a 1 m checker and furniture-scale
    boxes and spheres."""
    return [
        {"kind": "box_inner", "min": np.array([-5.0, -4.0, 0.0]),
         "max": np.array([5.0, 4.0, 3.0]),
         "color1": np.array([0.75, 0.72, 0.65], np.float32),
         "color2": np.array([0.45, 0.47, 0.52], np.float32)},
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


WORLDS = {"circuit": circuit_world, "room": room_world}


class World:
    """A world's primitives packed as float64 tensors on one device, in
    the list's order (the order decides ties, as in the numpy caster)."""

    def __init__(self, objects, device):
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                        device=device)
        self.device = device
        self.kind = torch.tensor([KINDS.index(o["kind"]) for o in objects],
                                 device=device)
        n = len(objects)
        lo = np.zeros((n, 3))
        hi = np.zeros((n, 3))
        col = np.zeros((n, 3))
        col2 = np.zeros((n, 3))
        ctr = np.zeros((n, 3))
        rad = np.zeros(n)
        tint = np.zeros(n)
        height = np.zeros(n)
        for i, o in enumerate(objects):
            k = o["kind"]
            if k == "plane":
                height[i] = o["z"]
                col[i], col2[i] = o["color1"], o["color2"]
            elif k == "box":
                lo[i], hi[i], col[i] = o["min"], o["max"], o["color"]
            elif k == "box_inner":
                lo[i], hi[i] = o["min"], o["max"]
                col[i], col2[i] = o["color1"], o["color2"]
            elif k == "sphere":
                ctr[i], rad[i], tint[i] = o["center"], o["radius"], \
                    o.get("tint", 1.0)
        # the colours are float32 in the world; kept as their float32 values
        col = col.astype(np.float32).astype(np.float64)
        col2 = col2.astype(np.float32).astype(np.float64)
        self.lo, self.hi, self.col, self.col2 = f64(lo), f64(hi), f64(col), \
            f64(col2)
        self.ctr, self.rad, self.tint, self.height = f64(ctr), f64(rad), \
            f64(tint), f64(height)

    def _t(self, o, d):
        """(N, n_obj) hit distances, inf where an object is missed."""
        inf = torch.tensor(float("inf"), dtype=torch.float64,
                           device=o.device)
        kind = self.kind[None, :]
        # plane z = h
        dz = d[:, 2:3]
        tp = (self.height[None, :] - o[:, 2:3]) / dz
        okp = (torch.abs(dz) > 1e-6) & (tp > 0.05)
        # boxes (outside and inside-out)
        inv = 1.0 / d
        t0 = (self.lo[None] - o[:, None, :]) * inv[:, None, :]
        t1 = (self.hi[None] - o[:, None, :]) * inv[:, None, :]
        tmin = torch.minimum(t0, t1).amax(dim=2)
        tmax = torch.maximum(t0, t1).amin(dim=2)
        okb = (tmax > tmin) & (tmin > 0.05)
        oki = tmax > 0.05
        # spheres
        oc = o[:, None, :] - self.ctr[None]
        b = torch.sum(d[:, None, :] * oc, dim=2)
        cc = torch.sum(oc * oc, dim=2) - self.rad[None] ** 2
        disc = b * b - cc
        ts = -b - torch.sqrt(torch.clamp_min(disc, 0))
        oks = (disc > 0) & (ts > 0.05)
        t = torch.where(kind == 0, tp, torch.where(
            kind == 1, tmin, torch.where(kind == 2, ts, tmax)))
        ok = torch.where(kind == 0, okp, torch.where(
            kind == 1, okb, torch.where(kind == 2, oks, oki)))
        return torch.where(ok, t, inf), t0, t1

    def cast(self, o: torch.Tensor, d: torch.Tensor, chunk: int = 1 << 17):
        """Ray-cast rays (o, d), (N, 3) float64: (t, hit, colour (N, 3)
        float32); t is 0 where nothing is hit."""
        ts, hits, cols = [], [], []
        for s in range(0, d.shape[0], chunk):
            t, h, c = self._cast(o[s:s + chunk], d[s:s + chunk])
            ts.append(t)
            hits.append(h)
            cols.append(c)
        return torch.cat(ts), torch.cat(hits), torch.cat(cols)

    def _cast(self, o, d):
        tall, _, _ = self._t(o, d)
        t, w = torch.min(tall, dim=1)   # the first of equal minima
        hit = torch.isfinite(t)
        t = torch.where(hit, t, torch.zeros_like(t))
        p = o + d * t[:, None]
        k = self.kind[w]
        # plane: a 1 m checker in x, y
        chk = torch.remainder(torch.floor(p[:, 0]) + torch.floor(p[:, 1]),
                              2).bool()
        c_plane = torch.where(chk[:, None], self.col[w], self.col2[w])
        # sphere: shaded by the normal
        nrm = (p - self.ctr[w]) / self.rad[w][:, None]
        c_sph = 0.5 + 0.4 * nrm * self.tint[w][:, None]
        # room shell: a 3-D checker, each wall pair tinted apart
        chk3 = torch.remainder(torch.floor(p[:, 0]) + torch.floor(p[:, 1])
                               + torch.floor(p[:, 2]), 2).bool()
        c_in = torch.where(chk3[:, None], self.col[w], self.col2[w])
        lo, hi = self.lo[w], self.hi[w]
        axis = torch.argmin(torch.minimum(torch.abs(p - lo),
                                          torch.abs(p - hi)), dim=1)
        tintmap = torch.tensor([[1.0, 0.85, 0.8], [0.8, 1.0, 0.85],
                                [0.85, 0.8, 1.0]], dtype=torch.float32,
                               device=o.device)
        c_in = (c_in.to(torch.float32) * tintmap[axis]).to(torch.float64)
        c = torch.where((k == 0)[:, None], c_plane, torch.where(
            (k == 1)[:, None], self.col[w], torch.where(
                (k == 2)[:, None], c_sph, c_in)))
        c = torch.where(hit[:, None], c, torch.zeros_like(c))
        return t, hit, c.to(torch.float32)
