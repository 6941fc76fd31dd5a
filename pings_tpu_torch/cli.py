"""Command-line entry point of the port.

Counterpart of ``pings_tpu/cli.py`` (``build_parser``, ``run`` and
``write_results``, :34-337), with one more flag, ``--device`` (default
``cuda``; without a card that raises, and ``--device cpu`` runs the plain
versions of the kernels):

    python -m pings_tpu_torch configs/kitti_synth.yaml \\
        --data-path data_validation/kitti_synth --range 0 100 1 --tag demo

It opens the configuration's dataset loader, runs every frame of the range
through ``SlamSystem.process_frame`` and writes the JAX package's run
directory: ``config_all.yaml``, ``run_info.json``, ``poses_kitti.txt``,
``odom_poses_kitti.txt``, ``pose_eval.csv``, ``time_table.csv``,
``metrics_table.csv``, ``summary.json``, ``traj_plot.png`` (where
matplotlib is installed), ``model/pin_map.npz`` when ``save_map``,
``merged_point_cloud.ply`` when ``save_merged_pc``, ``tsdf_mesh.ply`` (the
keyframes' depth maps fused into a TSDF) when ``save_tsdf_mesh`` and
``mesh.ply`` (the neural SDF's mesh) with ``--save-mesh`` or
``save_mesh`` (:160-189).

``--vis-every N`` (or ``vis_every`` in ``control.json``, which the frame
loop polls) saves a ``VisPacket`` every N frames and at the last frame into
``vis/frame_XXXXX.npz``, with the layers ``control.json`` asks for
(``mesh_on``, ``sdf_slice_on``, ``render_on``; ``_control_layers``,
:196-227), and bakes them into ``viewer.html`` at the end of the run.
``python -m pings_tpu_torch.vis.live RUN_DIR`` serves the packets and
writes ``control.json`` while the run goes on.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import time
from datetime import datetime

import numpy as np

from pings_tpu_torch.config import Config
from pings_tpu_torch.data.base import dataset_factory
from pings_tpu_torch.data.pointcloud_io import write_ply_points
from pings_tpu_torch.eval.traj import (
    absolute_error, plot_trajectories, relative_error, write_kitti_poses)
from pings_tpu_torch.slam.mesher import Mesher, write_ply
from pings_tpu_torch.slam.pipeline import SlamSystem
from pings_tpu_torch.slam.tsdf import fuse_run
from pings_tpu_torch.vis.control import ControlLoop
from pings_tpu_torch.vis.viewer import write_viewer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pings_tpu_torch",
        description="LiDAR-visual SLAM with a unified GS + SDF neural point "
                    "map (PyTorch/CUDA port)")
    p.add_argument("config", nargs="?", default=None,
                   help="YAML config file")
    p.add_argument("--data-path", default="", help="dataset root")
    p.add_argument("--loader", default=None,
                   help="dataset loader name (data.base.available_loaders())")
    p.add_argument("--seq", default=None, help="sequence name")
    p.add_argument("--range", nargs=3, type=int, default=None,
                   metavar=("BEGIN", "END", "STEP"), help="frame range")
    p.add_argument("--output", default=None, help="output root dir")
    p.add_argument("--tag", default="", help="run name tag")
    p.add_argument("--no-track", action="store_true",
                   help="mapping-only with GT/constant-velocity poses")
    p.add_argument("--no-gs", action="store_true",
                   help="disable gaussian-splatting mapping")
    p.add_argument("--save-mesh", action="store_true",
                   help="write the SDF's mesh (mesh.ply) at the end")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--vis-every", type=int, default=0, metavar="N",
                   help="save a VisPacket every N frames and bake a "
                        "standalone WebGL viewer.html at the end")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    return p


def run(args) -> dict:
    overrides = {}
    if args.loader:
        overrides["data_loader_name"] = args.loader
    if args.seq is not None:
        overrides["data_loader_seq"] = args.seq
    if args.data_path:
        overrides["pc_path"] = args.data_path
    if args.range:
        overrides["begin_frame"], overrides["end_frame"], \
            overrides["step_frame"] = args.range
    if args.output:
        overrides["output_root"] = args.output
    if args.no_track:
        overrides["track_on"] = False
    if args.no_gs:
        overrides["gs_on"] = False
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.quiet:
        overrides["silence"] = True
    cfg = Config.load(args.config, overrides)

    ds = dataset_factory(cfg.data_loader_name, cfg.pc_path,
                         cfg.data_loader_seq, cfg)
    begin, end, step = cfg.begin_frame, cfg.end_frame, max(cfg.step_frame, 1)
    if end < 0:
        end = len(ds)
    end = min(end, len(ds))
    # the system first: a missing card raises before the run directory is
    # made
    system = SlamSystem(cfg, device=args.device)

    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    run_name = "_".join(x for x in [cfg.name, args.tag, stamp] if x)
    run_dir = os.path.join(cfg.output_root, run_name)
    os.makedirs(run_dir, exist_ok=True)
    cfg.run_path = run_dir
    cfg.dump(os.path.join(run_dir, "config_all.yaml"))
    # repro record: the git hash (empty outside a git checkout) and the
    # command line
    try:
        git = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=5,
                             cwd=os.path.dirname(os.path.dirname(
                                 os.path.abspath(__file__)))).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        git = ""
    with open(os.path.join(run_dir, "run_info.json"), "w") as f:
        json.dump({"git_hash": git, "argv": sys.argv, "started": stamp}, f,
                  indent=2)

    gt = ds.gt_poses()
    reports = []
    packets = []
    # live control: <run_dir>/control.json is polled every frame
    ctrl = ControlLoop(run_dir)
    t_start = time.time()
    for fid in range(begin, end, step):
        if not ctrl.wait_if_paused():
            break                      # stop requested while paused
        st = ctrl.poll()
        if st.get("stop"):
            break
        rep = system.process_frame(ds[fid])
        reports.append(rep)
        vis_every = (int(st["vis_every"]) if st.get("vis_every")
                     is not None else args.vis_every)
        if vis_every and (len(reports) % vis_every == 0
                          or fid + step >= end):
            pkt = system.make_vis_packet(
                gt_poses=gt,
                with_render=bool(cfg.gs_on) and bool(
                    st.get("render_on", True)))
            _control_layers(pkt, st, system, cfg)
            pkt.save(os.path.join(run_dir, "vis",
                                  f"frame_{rep.frame_id:05d}.npz"))
            packets.append(pkt)
        if not cfg.silence:
            mets = " ".join(f"{k}={v:.3f}" for k, v in rep.metrics.items())
            print(f"[frame {rep.frame_id:4d}] pts={rep.n_points} "
                  f"track={'ok' if rep.tracking_valid else 'LOST'}"
                  f"{' LOOP' if rep.loop_closed else ''} {mets}",
                  flush=True)
        if system.aborted:
            print(f"System failed: {system.abort_reason or 'lost track'} "
                  "— writing results before the failure point", flush=True)
            break
    wall = time.time() - t_start

    results = write_results(run_dir, cfg, system, ds, reports, gt, wall)
    if packets:
        results["viewer"] = write_viewer(
            os.path.join(run_dir, "viewer.html"), packets)
    if cfg.save_map:
        system.save(os.path.join(run_dir, "model", "pin_map.npz"))
    if cfg.save_merged_pc:
        pc = system.merged_point_cloud()
        write_ply_points(os.path.join(run_dir, "merged_point_cloud.ply"),
                         pc[:, :3], pc[:, 3:6])
        results["merged_pc_points"] = len(pc)
    if cfg.save_tsdf_mesh and system.tsdf_frames:
        depths, Ks, Tcs, rgbs = zip(*system.tsdf_frames)
        vol = fuse_run(list(depths), list(Ks), list(Tcs), list(rgbs),
                       voxel=cfg.tsdf_fusion_voxel_size)
        v, t, c = vol.extract_mesh()
        write_ply(os.path.join(run_dir, "tsdf_mesh.ply"), v, t, c)
        results["tsdf_mesh_verts"] = len(v)
    if args.save_mesh or cfg.save_mesh:
        v, t, c = Mesher(cfg, system.device).recon_map_mesh(
            system.m, system.decoders)
        write_ply(os.path.join(run_dir, "mesh.ply"), v, t, c)
        results["mesh_verts"] = len(v)
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    if not cfg.silence:
        print(json.dumps(results, indent=2, default=float))
    return results


def _control_layers(pkt, st: dict, system, cfg):
    """The vis-packet layers ``control.json`` asks for: a mesh of the SDF
    in a box around the sensor (``mesh_on``) and a horizontal SDF slice
    through it (``sdf_slice_on``, at ``sdf_slice_height`` above the
    sensor). A failure leaves the layer out and prints why on stderr; the
    run goes on."""
    if not (st.get("mesh_on") or st.get("sdf_slice_on")):
        return
    mesher = Mesher(cfg, system.device)
    pos = system.poses[-1][:3, 3] if system.poses else np.zeros(3)
    r = min(0.25 * cfg.local_map_radius, 10.0)
    try:
        if st.get("mesh_on"):
            v, t, c = mesher.recon_aabb_mesh(
                system.m, system.decoders, pos - r, pos + r)
            pkt.mesh_verts, pkt.mesh_tris, pkt.mesh_colors = v, t, c
        if st.get("sdf_slice_on"):
            z = pos[2] + float(st.get("sdf_slice_height") or 0.0)
            res = max(cfg.mc_res_m, 2.0 * cfg.voxel_size_m)
            n = int(2 * r / res)
            origin = np.array([pos[0] - r, pos[1] - r, z])
            sdf, mask = mesher.query_sdf_grid(
                system.m, system.decoders, origin, (n, n, 1), res)
            pkt.sdf_slice = np.where(mask[:, :, 0], sdf[:, :, 0],
                                     np.nan).astype(np.float32)
            pkt.sdf_slice_meta = np.array(
                [origin[0], origin[1], z, res], np.float32)
    except Exception as e:   # vis layers are best-effort
        print(f"vis layers: {e!r}", file=sys.stderr, flush=True)


def write_results(run_dir, cfg, system, ds, reports, gt, wall) -> dict:
    """The run's results: summary numbers (returned), the KITTI-format
    poses of SLAM and of odometry alone, ATE and segment drift against the
    ground truth, the trajectory plot and the per-frame time and metric
    tables."""
    results = {"frames": len(reports), "wall_s": wall,
               "sec_per_frame": wall / max(len(reports), 1),
               "map_points": int(system.m.count),
               "loops": system.n_loops,
               "loops_uninformative": system.n_loops_uninformative,
               "loop_events": system.loop_events,
               "travel_m": round(system.travel[-1], 2) if system.travel
               else 0.0,
               "aborted": bool(system.aborted),
               "abort_reason": system.abort_reason}
    # per-stage mean seconds per frame
    stage_keys = sorted({k for r in reports for k in r.timings})
    if reports:
        results["stage_sec_per_frame"] = {
            k: round(sum(r.timings.get(k, 0.0) for r in reports)
                     / len(reports), 4)
            for k in stage_keys}
        # steady-state frame time over the last 40 frames
        tail = reports[-40:]
        results["sec_per_frame_steady"] = round(
            sum(sum(r.timings.values()) for r in tail) / len(tail), 2)
        results["max_frame_sec"] = round(
            max(sum(r.timings.values()) for r in reports), 1)
    # online GS training PSNR over the last frames
    psnrs = [r.metrics["gs_psnr"] for r in reports[-10:]
             if "gs_psnr" in r.metrics]
    if psnrs:
        results["gs_psnr"] = round(float(np.mean(psnrs)), 3)
    write_kitti_poses(os.path.join(run_dir, "poses_kitti.txt"), system.poses)
    write_kitti_poses(os.path.join(run_dir, "odom_poses_kitti.txt"),
                      system.odom_only_poses)
    if gt:
        used = [gt[i] for i in range(cfg.begin_frame,
                                     cfg.begin_frame + len(system.poses)
                                     * max(cfg.step_frame, 1),
                                     max(cfg.step_frame, 1))
                if i < len(gt)][: len(system.poses)]
        if len(used) == len(system.poses) and len(used) >= 3:
            ate = absolute_error(system.poses, used)
            # short segments for short sequences and the KITTI-standard
            # 100/200 m; relative_error averages over the reachable ones
            seglen = (10, 20, 40, 100, 200)
            rel = relative_error(system.poses, used,
                                 segment_lengths=seglen, step=2)
            results.update(ate)
            results.update(rel)
            # the odometry-only chain (before the pose graph), evaluated
            # the same way
            if len(system.odom_only_poses) == len(used):
                ate_o = absolute_error(system.odom_only_poses, used)
                rel_o = relative_error(system.odom_only_poses, used,
                                       segment_lengths=seglen, step=2)
                results["odom_only"] = {
                    "ate_trans_rmse_m": round(
                        ate_o["ate_trans_rmse_m"], 4),
                    "ate_rot_rmse_deg": round(
                        ate_o["ate_rot_rmse_deg"], 4),
                    "arte_trans_pct": rel_o.get("arte_trans_pct"),
                    "arte_rot_deg_per_100m": rel_o.get(
                        "arte_rot_deg_per_100m"),
                }
            try:
                plot_trajectories(os.path.join(run_dir, "traj_plot.png"),
                                  system.poses, used)
            except ImportError:
                print("traj_plot.png not written: matplotlib is not "
                      "installed", flush=True)
    # pose_eval.csv + timing table
    with open(os.path.join(run_dir, "pose_eval.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(results.keys()))
        w.writerow(list(results.values()))
    with open(os.path.join(run_dir, "time_table.csv"), "w", newline="") as f:
        w = csv.writer(f)
        keys = sorted({k for r in reports for k in r.timings})
        w.writerow(["frame"] + keys)
        for r in reports:
            w.writerow([r.frame_id] + [f"{r.timings.get(k, 0):.4f}"
                                       for k in keys])
    # per-frame scalar metrics (gs_psnr, sdf_bce, ...)
    mkeys = sorted({k for r in reports for k in r.metrics
                    if isinstance(r.metrics[k], (int, float))})
    if mkeys:
        with open(os.path.join(run_dir, "metrics_table.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["frame"] + mkeys)
            for r in reports:
                w.writerow([r.frame_id]
                           + [f"{r.metrics[k]:.4f}" if k in r.metrics
                              else "" for k in mkeys])
    return results


def main(argv=None):
    args = build_parser().parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
