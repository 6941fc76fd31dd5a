#!/usr/bin/env python3
"""ATE of SLAM without loop closure on the first frames of a sequence, one
run per seed, through ``SlamSystem.process_frame`` of either package.

    python3 scripts/slam_kitti_seeds.py --package torch --device cuda \
        --seeds 0,1,2,3,4,5 --gs on
    JAX_PLATFORMS=cpu python3 scripts/slam_kitti_seeds.py --package jax \
        --seeds 0,1,2,3,4,5 --gs off

The configuration is ``--config`` (default ``configs/kitti_synth.yaml``)
with ``pgo_on`` off, ``seed`` set per run (it seeds the map's and the
decoders' initial draws and the sampling) and each ``--set KEY=VALUE``
(a YAML value) applied. Without ``--data`` the frames are ``pings_tpu_torch
.data.synthetic.kitti_sequence`` (scans with the frame id as noise seed,
camera images without depth); with ``--data DIR`` they are the
configuration's loader (or ``--loader``) on ``DIR``, as the command line
opens it, for example the skewed and labelled kitti frames that
``scripts/torch_make_kitti_data.py --skew --labels`` writes:

    JAX_PLATFORMS=cpu python3 scripts/slam_kitti_seeds.py --package jax \
        --data DIR/kitti_synth --frames 12 --ate-frames 6 --gs off \
        --set deskew=true --set dynamic_filter_on=true \
        --set semantic_on=true --sem-acc --seeds 42,0,1

or the room of ``scripts/torch_make_replica_data.py`` tracked with
photometric rows (``--config configs/replica_synth.yaml --data
DIR/replica_synth --set photometric_loss_on=true --frames 10``).

The ATE is taken against the ground truth over the first ``--ate-frames``
frames (default all) with no alignment, the trajectory anchored at the
ground-truth start. With ``--sem-acc``, the share of the last frame's
labelled points (label >= 0, a valid query) whose class ``field.sem_at``
gives at the estimated pose is the label. Prints one JSON line per seed,
and one with the spread over the seeds; with ``--run DIR``, first the same
ATE of that committed run's odometry (``odom_poses_kitti.txt``). With
``--package torch`` the script imports nothing of JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def sem_accuracy(system, frame, pose, package: str) -> float:
    """Share of the frame's labelled points that ``sem_at`` classifies
    right, the points placed at ``pose``."""
    cfg = system.cfg
    labels = np.asarray(frame["sem"])
    pts = np.asarray(frame["points"], np.float32)[:, :3]
    pts_w = (pts @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
    kw = dict(k=cfg.query_nn_k, stencil_r=cfg.num_nei_cells,
              search_alpha=cfg.search_alpha)
    if package == "jax":
        import jax.numpy as jnp
        from pings_tpu.models import field
        lp, v = field.sem_at(system.m, system.decoders, jnp.asarray(pts_w),
                             **kw)
        pred, v = np.asarray(lp).argmax(-1), np.asarray(v)
    else:
        import torch
        from pings_tpu_torch.models import field
        with torch.no_grad():
            lp, v = field.sem_at(system.m, system.decoders, torch.as_tensor(
                pts_w, device=system.device), **kw)
        pred, v = lp.argmax(-1).cpu().numpy(), v.cpu().numpy()
    ok = v & (labels >= 0)
    return float((pred[ok] == labels[ok]).mean())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default="cuda",
                    help="the port's device (--package torch)")
    ap.add_argument("--seeds", default="0,1,2,3,4,5")
    ap.add_argument("--gs", default="on", help="on, off, or on,off for both")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--ate-frames", type=int, default=0,
                    help="ATE over the first N frames (default all)")
    ap.add_argument("--config",
                    default=os.path.join(ROOT, "configs", "kitti_synth.yaml"))
    ap.add_argument("--data", default=None,
                    help="dataset root for the configuration's loader "
                    "(default: the kitti circuit made in memory)")
    ap.add_argument("--loader", default=None)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", help="a configuration override")
    ap.add_argument("--sem-acc", action="store_true",
                    help="also the semantic accuracy on the last frame")
    ap.add_argument("--run", default=None,
                    help="a committed run directory: also print the ATE of "
                    "its odom_poses_kitti.txt over the same frames")
    args = ap.parse_args()

    from pings_tpu_torch.data.synthetic import kitti_poses, kitti_sequence
    from pings_tpu_torch.eval.traj import absolute_error, read_kitti_poses

    if args.run:
        odom = read_kitti_poses(os.path.join(args.run, "odom_poses_kitti.txt"))
        print(json.dumps({"run": args.run, **absolute_error(
            odom[:args.frames], kitti_poses(args.frames), align=False)}))

    if args.package == "jax":
        from pings_tpu.config import Config
        from pings_tpu.data.base import dataset_factory
        from pings_tpu.slam.pipeline import SlamSystem
        make = SlamSystem
    else:
        from pings_tpu_torch.config import Config
        from pings_tpu_torch.data.base import dataset_factory
        from pings_tpu_torch.slam.pipeline import SlamSystem

        def make(cfg):
            return SlamSystem(cfg, device=args.device)

    sets = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        sets[k] = yaml.safe_load(v)
    if args.loader:
        sets["data_loader_name"] = args.loader
    if args.data is None:
        frames = kitti_sequence(args.frames)
    else:
        cfg = Config.load(args.config, overrides=dict(sets))
        ds = dataset_factory(cfg.data_loader_name, args.data,
                             cfg.data_loader_seq, cfg)
        frames = [ds[i] for i in range(min(args.frames, len(ds)))]
    gt = [f["gt_pose"] for f in frames]
    n_ate = args.ate_frames or len(frames)
    for gs in args.gs.split(","):
        ates, accs = [], []
        for seed in [int(s) for s in args.seeds.split(",") if s]:
            cfg = Config.load(args.config, overrides=dict(
                sets, pgo_on=False, seed=seed, gs_on=gs == "on"))
            system = make(cfg)
            t0 = time.perf_counter()
            valid = [system.process_frame(f).tracking_valid for f in frames]
            ate = absolute_error(system.poses[:n_ate], gt[:n_ate],
                                 align=False)
            ates.append(ate["ate_trans_rmse_m"])
            extra = {}
            if args.sem_acc:
                extra["sem_acc"] = sem_accuracy(system, frames[-1],
                                                system.poses[-1],
                                                args.package)
                accs.append(extra["sem_acc"])
            print(json.dumps({
                "package": args.package, "seed": seed, "gs": gs,
                "valid": valid, "s": round(time.perf_counter() - t0, 1),
                **ate, **extra, "position_error_m": [
                    np.round(p[:3, 3] - g[:3, 3], 4).tolist()
                    for p, g in zip(system.poses, gt)]}), flush=True)
        if ates:
            spread = {"package": args.package, "gs": gs,
                      "ate_trans_rmse_m": {"min": min(ates),
                                           "median": float(np.median(ates)),
                                           "max": max(ates)}}
            if accs:
                spread["sem_acc"] = {"min": min(accs),
                                     "median": float(np.median(accs)),
                                     "max": max(accs)}
            print(json.dumps(spread), flush=True)


if __name__ == "__main__":
    main()
