"""Offline map inspector: load a saved run and re-render it on the card.

Counterpart of ``pings_tpu/inspect_map.py`` for rendering
(``build_parser`` .. ``render_poses`` :29-151, ``main`` :303-363): loads
the map checkpoint and decoders from a run directory written by the JAX
package, re-creates the local map around each pose, and renders along
the saved (or a given) trajectory into PNGs or an MP4.

Usage:
    python -m pings_tpu_torch.inspect_map RUN_DIR --render
        [--frame N] [--poses FILE] [--stride S] [--width W --height H
        --fx F] [--video out.mp4] [--device cuda|cpu]

``--eval``, ``--recon-3d``, ``--sdf-slice`` and ``--export-points`` are
not ported yet and exit with an error; ``refine_view_pose`` (:236-274),
the per-view pose refinement that ``--eval`` will use, is. ``--video`` needs the ``imageio``
package (with its ffmpeg plugin) to encode the MP4.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import struct
import zlib

import numpy as np
import torch

from pings_tpu_torch.config import Config

_NOT_PORTED = ("eval", "recon_3d", "sdf_slice", "export_points")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pings_tpu_torch.inspect_map",
        description="Re-render a saved pings_tpu map checkpoint with the "
                    "PyTorch/CUDA port")
    p.add_argument("run_dir", help="run directory (contains model/pin_map.npz)")
    p.add_argument("--frame", "-f", type=int, default=-1,
                   help="render only this frame's pose (-1 = all)")
    p.add_argument("--render", action="store_true",
                   help="re-render the saved trajectory to PNGs")
    p.add_argument("--poses", default=None,
                   help="render with poses from this KITTI-format file "
                        "instead of the saved trajectory")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--fx", type=float, default=300.0)
    p.add_argument("--video", default=None, help="write an mp4 instead of PNGs")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    p.add_argument("--out", default=None,
                   help="output dir (default RUN_DIR/inspect)")
    # not ported yet: accepted so that the error says so
    p.add_argument("--recon-3d", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--sdf-slice", type=float, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--export-points", default=None, help=argparse.SUPPRESS)
    p.add_argument("--eval", action="store_true", help=argparse.SUPPRESS)
    return p


def load_system(run_dir: str, device: str | torch.device = "cuda",
                gs_on: bool = False):
    """(cfg, system) of a saved run. A run's flat ``config_all.yaml`` has
    no sections, and ``Config.load`` turns a subsystem off when its section
    is missing, whatever the file's ``gs_on`` says; ``gs_on=True`` turns
    the GS subsystem (keyframe pool, exposure and pose-delta pools) back
    on, for training on the loaded map."""
    from pings_tpu_torch.slam.pipeline import SlamSystem

    cfg_file = os.path.join(run_dir, "config_all.yaml")
    cfg = Config.load(cfg_file) if os.path.exists(cfg_file) else Config()
    cfg.silence = True
    cfg.gs_on = cfg.gs_on or gs_on
    system = SlamSystem(cfg, device=device)
    ckpt = os.path.join(run_dir, "model", "pin_map.npz")
    if not os.path.exists(ckpt):
        cands = glob.glob(os.path.join(run_dir, "**", "pin_map.npz"),
                          recursive=True)
        if not cands:
            raise FileNotFoundError(f"no pin_map.npz under {run_dir}")
        ckpt = cands[0]
    system.load(ckpt)
    return cfg, system


def _camera(args, T_w_c: np.ndarray, device):
    from pings_tpu_torch.models.renderer import CamView

    K = np.array([[args.fx, 0, args.width / 2],
                  [0, args.fx, args.height / 2], [0, 0, 1.0]])
    T_c_w = np.linalg.inv(T_w_c)
    z = torch.zeros((args.height, args.width), device=device)
    return CamView(K=torch.as_tensor(K, dtype=torch.float32, device=device),
                   T_c_w=torch.as_tensor(T_c_w, dtype=torch.float32,
                                         device=device),
                   rgb=torch.zeros((args.height, args.width, 3),
                                   device=device),
                   depth=z, sky=z, frame_id=0)


def _local_data(cfg, system, center: np.ndarray):
    from pings_tpu_torch.models import neural_points as npm
    from pings_tpu_torch.models.spawn import gather_local_data

    # offline: pure spatial mask (no travel-distance window)
    mask, _sur = npm.compute_local_mask(
        system.m, torch.as_tensor(center, dtype=torch.float32,
                                  device=system.device),
        0, system.travel_dev, float(cfg.local_map_radius), float(np.inf),
        max_local=cfg.max_local_points)
    return gather_local_data(system.m, mask, cfg.max_local_points)


def write_png(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def render_poses(args, cfg, system, poses, out_dir):
    """Re-render the map along ``poses`` (T_w_c); returns the frame count."""
    from pings_tpu_torch.models.renderer import render
    from pings_tpu_torch.models.spawn import spawn_kwargs_from_cfg

    os.makedirs(out_dir, exist_ok=True)
    frames = []
    local = None
    last_center = None
    for i, T in enumerate(poses[::args.stride]):
        center = T[:3, 3]
        if last_center is None or \
                np.linalg.norm(center - last_center) > 0.5 * float(
                    cfg.local_map_radius):
            local = _local_data(cfg, system, center)
            last_center = center
        cam = _camera(args, T, system.device)
        res = render(local, system.decoders, cam, args.width, args.height,
                     spawn_kwargs=spawn_kwargs_from_cfg(cfg),
                     max_per_tile=cfg.max_gs_per_tile,
                     gs_type=cfg.gs_type, precision=cfg.raster_precision,
                     device=system.device)
        rgb = np.clip(res.rgb.cpu().numpy() * 255, 0, 255).astype(np.uint8)
        if args.video is None:
            write_png(os.path.join(out_dir, f"render_{i:05d}.png"), rgb)
        else:
            frames.append(rgb)
    if args.video is not None and frames:
        import imageio.v2 as imageio

        imageio.mimwrite(os.path.join(out_dir, args.video), frames, fps=10)
    return len(poses[::args.stride])


def refine_view_pose(cfg, local, decoders, cam, w: int, h: int,
                     iters: int = 50, lr: float = 1e-3,
                     device: str | torch.device = "cuda"):
    """Per-view camera pose refinement before evaluation: optimize a
    (theta, rho) se3 delta with Adam on the Tukey-robust photometric loss
    (c = 0.5) against the target view ``cam.rgb``. Returns the refined
    (theta, rho) to pass into ``render()``."""
    from pings_tpu_torch import resolve_device
    from pings_tpu_torch.mapping.losses import tukey_loss
    from pings_tpu_torch.mapping.sdf_mapper import AdamW
    from pings_tpu_torch.models.renderer import render
    from pings_tpu_torch.models.spawn import spawn_kwargs_from_cfg

    dev = resolve_device(device)
    spawn_kwargs = spawn_kwargs_from_cfg(cfg)
    theta = torch.zeros(3, device=dev, requires_grad=True)
    rho = torch.zeros(3, device=dev, requires_grad=True)
    target = cam.rgb.to(dev)
    opt = AdamW([theta, rho], lr=lr, eps=1e-8)
    for _ in range(iters):
        theta.grad = rho.grad = None
        res = render(local, decoders, cam, w, h, theta=theta, rho=rho,
                     spawn_kwargs=spawn_kwargs,
                     max_per_tile=cfg.max_gs_per_tile, gs_type=cfg.gs_type,
                     precision=cfg.raster_precision, device=dev)
        tukey_loss(res.rgb, target, c=0.5).backward()
        opt.step()
    return theta.detach(), rho.detach()


def main(argv=None):
    args = build_parser().parse_args(argv)
    asked = [f for f in _NOT_PORTED if getattr(args, f) not in (None, False)]
    if asked:
        flags = ", ".join("--" + f.replace("_", "-") for f in asked)
        raise SystemExit(f"pings_tpu_torch.inspect_map: {flags} not yet "
                         "ported (use python -m pings_tpu.inspect_map)")
    cfg, system = load_system(args.run_dir, device=args.device)
    out_dir = args.out or os.path.join(args.run_dir, "inspect")
    os.makedirs(out_dir, exist_ok=True)
    report = {"map_points": int(system.m.count),
              "n_poses": len(system.poses)}

    if args.render or args.video:
        if args.poses:
            from pings_tpu_torch.eval.traj import read_kitti_poses

            poses = read_kitti_poses(args.poses)
        else:
            poses = system.poses
        if args.frame >= 0:
            poses = poses[args.frame:args.frame + 1]
        report["rendered"] = render_poses(args, cfg, system, poses,
                                          os.path.join(out_dir, "renders"))

    print(json.dumps(report, indent=2, default=float))
    return report


if __name__ == "__main__":
    main()
