#!/usr/bin/env python3
"""The loop-closure cell of ``chip_smoke.py`` (``slam_loop``) once per
seed, through ``SlamSystem.process_frame`` of either package.

    python3 scripts/slam_loop_seeds.py --package torch --device cpu \
        --seeds 0,1,2,3
    JAX_PLATFORMS=cpu python3 scripts/slam_loop_seeds.py --package jax \
        --seeds 0,1,2,3

The world is ``"60:circle"`` run past its 37.7 m lap (``--frames``, default
70) with ``chip_smoke.loop_cfg`` and ``seed`` set per run (it seeds the
map's and the decoders' initial draws and the sampling; the two packages
draw differently for the same seed). The system trains the SDF alone until
the first applied loop and GS from the frame after it, as the smoke does.
Prints one JSON line per seed: the estimated and the true travel, the
last frame's position error, the frames that lost track, the loop
decisions, and whether the smoke's checks pass (travel within 10%, no lost
frame, an applied loop and a rejection). About 7 minutes a seed on two
CPU threads (torch) and 1-4 minutes (jax). With ``--package torch`` the
script imports nothing of JAX.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def make_system(package: str, seed: int, device: str):
    import chip_smoke as cs

    cfg = cs.loop_cfg(seed=seed)
    if package == "torch":
        from pings_tpu_torch.data.synthetic import SyntheticDataset
        from pings_tpu_torch.slam.pipeline import SlamSystem

        return SlamSystem(cfg, device=device), SyntheticDataset
    from pings_tpu.config import Config
    from pings_tpu.data.synthetic import SyntheticDataset
    from pings_tpu.slam.pipeline import SlamSystem

    return (SlamSystem(Config.load(overrides=dataclasses.asdict(cfg))),
            SyntheticDataset)


def run(package: str, seed: int, device: str, n: int) -> dict:
    system, dataset = make_system(package, seed, device)
    ds = dataset(sequence="60:circle")
    ds._poses = [ds._pose(i) for i in range(n)]   # past the lap's end
    system.cfg.gs_on = False   # GS from the frame after the first loop
    gt, lost = [], []
    t0 = time.perf_counter()
    for i in range(n):
        frame = ds[i]
        gt.append(frame["gt_pose"])
        rep = system.process_frame(frame)
        if rep.loop_closed:
            system.cfg.gs_on = True
        if i and not rep.tracking_valid:
            lost.append(i)
    gt_travel = float(sum(np.linalg.norm(a[:3, 3] - b[:3, 3])
                          for a, b in zip(gt[1:], gt[:-1])))
    dec = [e["decision"] for e in system.loop_events]
    applied = dec.count("applied")
    travel = float(system.travel[-1])
    err = np.asarray(system.poses[-1])[:3, 3] - gt[-1][:3, 3]
    return dict(
        package=package, seed=seed, frames=n, travel_m=round(travel, 3),
        gt_travel_m=round(gt_travel, 3),
        last_position_error_m=round(float(np.linalg.norm(err)), 3),
        lost=lost, applied=applied, decisions=len(dec),
        smoke_checks_pass=bool(not lost and abs(travel - gt_travel)
                               <= 0.1 * gt_travel and applied
                               and len(dec) > applied),
        seconds=round(time.perf_counter() - t0, 1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--device", default="cpu",
                    help="torch only: cpu or cuda")
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--frames", type=int, default=70)
    args = ap.parse_args()
    if args.package == "torch":
        import torch

        if args.device == "cpu":
            torch.set_num_threads(2)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(run(args.package, seed, args.device, args.frames)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
