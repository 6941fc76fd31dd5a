#!/usr/bin/env python3
"""ATE of SLAM without loop closure on the first frames of the kitti
circuit, one run per seed, through ``SlamSystem.process_frame`` of either
package.

    python3 scripts/slam_kitti_seeds.py --package torch --device cuda \
        --seeds 0,1,2,3,4,5 --gs on
    JAX_PLATFORMS=cpu python3 scripts/slam_kitti_seeds.py --package jax \
        --seeds 0,1,2,3,4,5 --gs off

The configuration is ``configs/kitti_synth.yaml`` with ``pgo_on`` off and
``seed`` set per run (it seeds the map's and the decoders' initial draws and
the sampling); the frames are ``pings_tpu_torch.data.synthetic
.kitti_sequence`` (scans with the frame id as noise seed, camera images
without depth). The ATE is taken against the ground truth with no alignment,
the trajectory anchored at the ground-truth start. Prints one JSON line per
seed, and one with the spread over the seeds; with ``--run DIR``, first the
same ATE of that committed run's odometry (``odom_poses_kitti.txt``). With
``--package torch`` the script imports nothing of JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default="cuda",
                    help="the port's device (--package torch)")
    ap.add_argument("--seeds", default="0,1,2,3,4,5")
    ap.add_argument("--gs", default="on", help="on, off, or on,off for both")
    ap.add_argument("--frames", type=int, default=6)
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
        from pings_tpu.slam.pipeline import SlamSystem
        make = SlamSystem
    else:
        from pings_tpu_torch.config import Config
        from pings_tpu_torch.slam.pipeline import SlamSystem

        def make(cfg):
            return SlamSystem(cfg, device=args.device)

    frames = kitti_sequence(args.frames)
    gt = [f["gt_pose"] for f in frames]
    for gs in args.gs.split(","):
        ates = []
        for seed in [int(s) for s in args.seeds.split(",") if s]:
            cfg = Config.load(
                os.path.join(ROOT, "configs", "kitti_synth.yaml"),
                overrides={"pgo_on": False, "seed": seed,
                           "gs_on": gs == "on"})
            system = make(cfg)
            t0 = time.perf_counter()
            valid = [system.process_frame(f).tracking_valid for f in frames]
            ate = absolute_error(system.poses, gt, align=False)
            ates.append(ate["ate_trans_rmse_m"])
            print(json.dumps({
                "package": args.package, "seed": seed, "gs": gs,
                "valid": valid, "s": round(time.perf_counter() - t0, 1),
                **ate, "position_error_m": [
                    np.round(p[:3, 3] - g[:3, 3], 4).tolist()
                    for p, g in zip(system.poses, gt)]}), flush=True)
        if ates:
            print(json.dumps({"package": args.package, "gs": gs,
                              "ate_trans_rmse_m": {
                                  "min": min(ates),
                                  "median": float(np.median(ates)),
                                  "max": max(ates)}}), flush=True)


if __name__ == "__main__":
    main()
