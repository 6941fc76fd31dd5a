"""The one generator of the benchmark's traffic. A traffic file
(``traffic/<name>.json``) gives its ``kind`` and parameters; the
configuration's ``sensor`` and ``world`` give what is sensed. The world,
the trajectory, the LiDAR's range noise (drawn from the sensor's
``noise_seed``, as a recorded sequence holds one fixed set of scans) and
the decoders' seed belong to the configuration. ``--seed`` draws what
changes no amount of work: the camera images' noise and the frames the
check takes (``slam_stream``), or the order of a fixed set of views
(``serve_path``). Every seed so sees the same sizes and the same work.

- ``slam_stream``: frames in order, a closed loop (the next frame is
  handed over when ``process_frame`` returns). ``warm_frames`` frames are
  mapped in set-up; the window maps the frames after them. Set-up builds
  the warm frames, maps them, then builds ``ceil(seconds / (share x t))``
  more, where ``t`` is the last warm frame's time and ``share`` is
  ``frame_time_share``, at most the sequence's length. Frames are built
  in order from one generator each for the images and the scans, so a
  frame is the same however many are built.
- ``serve_path``: one viewer in a closed loop. ``view_set`` views are
  drawn once from ``view_set_seed``: the orbit's poses, each moved by a
  random offset of up to ``perturb_m`` per axis and turned about a random
  axis by up to ``perturb_deg``. The seed orders them once; the first
  ``warm_views`` of that order are warmed in set-up, and the window goes
  round the whole order as often as its time allows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.gen import sensors, world as wd


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) & ((1 << 64) - 1))


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


class SlamStream:
    """The frames and ground-truth poses of a ``slam_stream``, built in
    order on demand."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.sen = sen = config["sensor"]
        self.traffic = traffic
        self.device = device
        self.n_seq = sen["frames"]
        self.world = wd.World(wd.WORLDS[config["world"]](), device)
        self.gen = _gen(seed, device)
        self.lidar_gen = _gen(sen.get("noise_seed", 0), device)
        self.K = np.asarray(sen["cam_K"], np.float64)
        self.T_c_l = np.asarray(sen["cam_T_c_l"], np.float64)
        if sen["kind"] == "lidar_camera":
            self.gt = sensors.kitti_poses(self.n_seq, sen["step_m"],
                                          sen["height_m"])
            self.dirs = torch.as_tensor(sensors.lidar_dirs(
                sen["lidar_beams"], sen["lidar_azimuths"],
                sen["lidar_el_min_deg"], sen["lidar_el_max_deg"]),
                dtype=torch.float64, device=device)
        elif sen["kind"] == "rgbd":
            self.gt = [sensors.orbit_pose(f, self.n_seq)
                       for f in range(self.n_seq)]
        else:
            raise ValueError(f"unknown sensor kind {sen['kind']!r}")
        self.frames = []

    def window_frames(self, seconds: float, warm_frame_s: float) -> int:
        """How many frames a window of ``seconds`` may map, from the last
        warm frame's time."""
        share = self.traffic["frame_time_share"]
        return int(math.ceil(seconds / (share * max(warm_frame_s, 1e-3))))

    def build(self, n: int) -> list:
        """The first ``n`` frames (at most the sequence's length)."""
        sen, w, K, T_c_l = self.sen, self.world, self.K, self.T_c_l
        W, H = sen["cam_width"], sen["cam_height"]
        noise = self.traffic["image_noise"]
        for fid in range(len(self.frames), min(n, self.n_seq)):
            T = self.gt[fid]
            if sen["kind"] == "lidar_camera":
                pts = sensors.lidar_scan(w, T, self.dirs,
                                         sen["lidar_noise_m"],
                                         self.lidar_gen, sen["lidar_min_m"],
                                         sen["lidar_max_m"])
                img, _ = sensors.pinhole(w, T @ sensors.se3_inv(T_c_l), K,
                                         W, H)
                img = sensors.add_image_noise(img, noise, self.gen)
                fr = {"points": pts, "img": {"cam": img.cpu().numpy()}}
            else:
                img, depth = sensors.pinhole(w, T, K, W, H)
                img = sensors.add_image_noise(img, noise, self.gen)
                stride = 2 if depth.numel() > 400000 else 1
                fr = {"points": sensors.backproject(depth, K, img, stride),
                      "img": {"cam": img.cpu().numpy()},
                      "depth": {"cam": depth.cpu().numpy()}}
            fr.update({"K": {"cam": K}, "T_c_l": {"cam": T_c_l},
                       "gt_pose": T})
            self.frames.append(fr)
        return self.frames


def serve_views(config: dict, traffic: dict, seed: int):
    """Camera-to-world poses (float64 4x4) of a ``serve_path``: the view
    set in the seed's order, then its first ``warm_views`` again (the
    window starts after the warm views and wraps round the set)."""
    sen = config["sensor"]
    n_orbit = sen["frames"]
    fixed = _rng(traffic["view_set_seed"])
    dm, da = traffic["perturb_m"], math.radians(traffic["perturb_deg"])
    views = []
    for k in range(traffic["view_set"]):
        T = sensors.orbit_pose(k % n_orbit, n_orbit)
        axis = fixed.normal(size=3)
        axis /= np.linalg.norm(axis)
        P = T.copy()
        P[:3, :3] = T[:3, :3] @ sensors.so3_exp(axis
                                                * fixed.uniform(-da, da))
        P[:3, 3] = T[:3, 3] + fixed.uniform(-dm, dm, 3)
        views.append(P)
    order = [views[int(i)] for i in _rng(seed).permutation(len(views))]
    return order + order[:traffic["warm_views"]]
