"""Offline map inspector: load a saved run and re-render, evaluate and
mesh it on the card.

Counterpart of ``pings_tpu/inspect_map.py`` (:1-363): loads the map
checkpoint and decoders from a run directory written by either package,
re-creates the local map around each pose and renders along the saved
(or a given) trajectory into PNGs or an MP4 (``--render``); evaluates
every frame of the dataset against its render, every ``--eval-every``-th
as a held-out test view (``--eval``: ``inspect/gs_eval.csv``, PSNR, SSIM,
LPIPS, depth L1, with ``--cam-refine`` after a per-view pose refinement);
meshes the SDF (``--recon-3d``: ``mesh.ply``), writes a horizontal SDF
slice (``--sdf-slice Z``: ``sdf_slice.npy``) and the neural points
coloured by rgb, height, creation time or certainty (``--export-points``).

Usage:
    python -m pings_tpu_torch.inspect_map RUN_DIR [--render] [--frame N]
        [--poses FILE] [--stride S] [--width W --height H --fx F]
        [--video out.mp4] [--recon-3d] [--mc-res R] [--sdf-slice Z]
        [--export-points rgb|height|time|certainty]
        [--eval --loader L --data-path P --seq S --eval-every N
        --cam-refine] [--out DIR] [--device cuda|cpu]

``--video`` needs the ``imageio`` package (with its ffmpeg plugin) to
encode the MP4. The report printed at the end has the JAX package's keys.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from pings_tpu_torch.config import Config
from pings_tpu_torch.data.base import dataset_factory
from pings_tpu_torch.data.imageio import write_png
from pings_tpu_torch.eval.image import image_metrics
from pings_tpu_torch.models.renderer import CamView, render
from pings_tpu_torch.models.spawn import spawn_kwargs_from_cfg
from pings_tpu_torch.slam.mesher import Mesher, write_ply


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
    p.add_argument("--recon-3d", action="store_true",
                   help="mesh the SDF (mesh.ply)")
    p.add_argument("--mc-res", type=float, default=None)
    p.add_argument("--sdf-slice", type=float, default=None,
                   metavar="HEIGHT", help="write a horizontal SDF slice npy")
    p.add_argument("--export-points", default=None,
                   choices=["rgb", "height", "time", "certainty"],
                   help="dump the neural point cloud as .ply colored by MODE")
    p.add_argument("--eval", action="store_true",
                   help="held-out NVS eval against dataset frames")
    p.add_argument("--loader", default=None)
    p.add_argument("--data-path", default="")
    p.add_argument("--seq", default=None)
    p.add_argument("--eval-every", type=int, default=5,
                   help="use every Nth frame as a test view")
    p.add_argument("--cam-refine", action="store_true",
                   help="refine each view's camera pose before evaluating "
                        "it (sets gs_eval_cam_refine_on; needed along an "
                        "estimated trajectory)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    p.add_argument("--out", default=None,
                   help="output dir (default RUN_DIR/inspect)")
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
    system = SlamSystem(cfg, device=device, fresh=False)
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


def render_poses(args, cfg, system, poses, out_dir):
    """Re-render the map along ``poses`` (T_w_c); returns the frame count."""
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


def eval_heldout(args, cfg, system, out_dir):
    """Held-out view metrics -> ``gs_eval.csv``: every frame of the dataset
    (up to the saved trajectory's length) rendered at its own camera and
    pose and compared with its image and depth; frames whose index is a
    multiple of ``args.eval_every`` form the test split. Returns the mean
    of each metric per split."""
    import csv

    if getattr(args, "cam_refine", False):
        cfg.gs_eval_cam_refine_on = True
    dev = system.device
    ds = dataset_factory(args.loader or cfg.data_loader_name,
                         args.data_path or cfg.pc_path,
                         args.seq if args.seq is not None
                         else cfg.data_loader_seq, cfg)
    rows = []
    poses = system.poses
    local, last_center = None, None
    for i in range(0, min(len(ds), len(poses))):
        fr = ds[i]
        if "img" not in fr:
            continue
        cam_name = next(iter(fr["img"]))
        img = fr["img"][cam_name].astype(np.float32) / 255.0
        h, w = img.shape[:2]
        K = np.asarray(fr["K"][cam_name])
        T_c_l = np.asarray(fr["T_c_l"][cam_name])
        T_c_w = T_c_l @ np.linalg.inv(poses[i])
        center = poses[i][:3, 3]
        if last_center is None or np.linalg.norm(center - last_center) > \
                0.5 * float(cfg.local_map_radius):
            local = _local_data(cfg, system, center)
            last_center = center
        target = torch.as_tensor(img, device=dev)
        z = torch.zeros((h, w), device=dev)
        cam = CamView(K=torch.as_tensor(K, dtype=torch.float32, device=dev),
                      T_c_w=torch.as_tensor(T_c_w, dtype=torch.float32,
                                            device=dev),
                      rgb=target, depth=z, sky=z, frame_id=i)
        theta = rho = None
        if cfg.gs_eval_cam_refine_on:
            theta, rho = refine_view_pose(
                cfg, local, system.decoders, cam, w, h,
                iters=cfg.gs_eval_cam_refine_iters, device=dev)
        with torch.no_grad():
            res = render(local, system.decoders, cam, w, h,
                         theta=theta, rho=rho,
                         spawn_kwargs=spawn_kwargs_from_cfg(cfg),
                         max_per_tile=cfg.max_gs_per_tile,
                         gs_type=cfg.gs_type,
                         precision=cfg.raster_precision, device=dev)
        met = image_metrics(res.rgb, target, with_lpips=True, device=dev)
        met["frame"] = i
        met["split"] = "test" if i % args.eval_every == 0 else "train"
        if "depth" in fr:
            d_gt = np.asarray(fr["depth"][cam_name])
            d_pred = res.depth.cpu().numpy()
            ok = d_gt > 1e-4
            if ok.any():
                met["depth_l1"] = float(
                    np.abs(d_pred[ok] - d_gt[ok]).mean())
        rows.append(met)
    if rows:
        keys = sorted({k for r in rows for k in r})
        with open(os.path.join(out_dir, "gs_eval.csv"), "w",
                  newline="") as f:
            wtr = csv.DictWriter(f, fieldnames=keys)
            wtr.writeheader()
            wtr.writerows(rows)
    summary = {}
    for split in ("train", "test"):
        sel = [r for r in rows if r["split"] == split]
        if sel:
            for k in ("psnr", "ssim", "lpips", "lpips_rand", "depth_l1"):
                vals = [r[k] for r in sel if k in r]
                if vals:
                    summary[f"{split}_{k}"] = float(np.mean(vals))
    return summary


def export_points(system, mode: str, path: str) -> int:
    """Write the map's neural points as a PLY coloured by ``mode`` (rgb,
    height, time or certainty); returns the point count."""
    m = system.m
    n = int(m.count)
    xyz = m.positions[:n].cpu().numpy()
    if mode == "rgb":
        col = np.clip(m.rgb[:n].cpu().numpy(), 0, 1)
    elif mode == "height":
        z = xyz[:, 2]
        t = (z - z.min()) / max(z.max() - z.min(), 1e-6)
        col = np.stack([t, 1 - np.abs(t - 0.5) * 2, 1 - t], -1)
    elif mode == "time":
        t = m.ts_create[:n].cpu().numpy().astype(np.float32)
        t = t / max(t.max(), 1.0)
        col = np.stack([t, 1 - t, np.zeros_like(t)], -1)
    else:  # certainty
        c = m.certainty[:n].cpu().numpy()
        c = c / max(float(c.max()), 1e-6)
        col = np.stack([c, c, c], -1)
    write_ply(path, xyz, np.zeros((0, 3), np.int32), col)
    return n


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg, system = load_system(args.run_dir, device=args.device)
    out_dir = args.out or os.path.join(args.run_dir, "inspect")
    os.makedirs(out_dir, exist_ok=True)
    report = {"map_points": int(system.m.count),
              "n_poses": len(system.poses)}

    if args.export_points:
        path = os.path.join(out_dir, f"neural_points_{args.export_points}.ply")
        report["exported_points"] = export_points(
            system, args.export_points, path)

    if args.sdf_slice is not None:
        mesher = Mesher(cfg, system.device)
        n = int(system.m.count)
        xyz = system.m.positions[:n].cpu().numpy()
        lo, hi = xyz.min(0), xyz.max(0)
        res = args.mc_res or cfg.mc_res_m
        dims = (max(int((hi[0] - lo[0]) / res), 1),
                max(int((hi[1] - lo[1]) / res), 1), 1)
        origin = np.array([lo[0], lo[1], args.sdf_slice])
        sdf, valid = mesher.query_sdf_grid(system.m, system.decoders,
                                           origin, dims, res)
        np.save(os.path.join(out_dir, "sdf_slice.npy"),
                np.where(valid, sdf, np.nan)[:, :, 0])
        report["sdf_slice"] = [dims[0], dims[1]]

    if args.recon_3d:
        if args.mc_res:
            cfg.mc_res_m = args.mc_res
        v, t, c = Mesher(cfg, system.device).recon_map_mesh(
            system.m, system.decoders)
        write_ply(os.path.join(out_dir, "mesh.ply"), v, t, c)
        report["mesh_verts"] = len(v)

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

    if args.eval:
        report.update(eval_heldout(args, cfg, system, out_dir))

    print(json.dumps(report, indent=2, default=float))
    return report


if __name__ == "__main__":
    main()
