#!/usr/bin/env python3
"""How far apart the two packages' SLAM slices run, seed by seed: the
comparison of ``tests/test_torch_process_frame.py`` (``run_slice``: both
``SlamSystem``s on ``"4:line"`` at the tiny configuration, the port on the
CPU from the JAX package's initial decoders and random draws) at each
``--seeds`` value of the configuration's ``seed``. Prints one JSON line per
seed with, per frame, the position difference (cm), the rotation
difference (deg), the relative differences of the last SDF batch's BCE and
of the map's count and both tracking flags, and over the run the largest
difference of the travelled distance (cm) and both ATEs against the ground
truth (m); then one line with the largest of each per frame.

    python3 tests/torch_slam_parity_sweep.py --seeds 42,0,1,2,3,4,5

It imports both packages, like the tests beside it, and runs JAX on the
CPU; about 80 s a seed.
"""

import argparse
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pings_tpu.utils import pose as hp  # noqa: E402
from pings_tpu_torch.eval.traj import absolute_error  # noqa: E402
from torch_slam_helpers import run_slice  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="42,0,1,2,3,4,5")
    args = ap.parse_args()
    torch.set_num_threads(1)    # as the tests' ``one_torch_thread``
    worst = None
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        out, _, ds, js, ts = run_slice(seed=seed)
        rows = []
        for jr, tr, jT, tT, jn, tn in out:
            d = hp.se3_inv(jT) @ tT
            rows.append({
                "dpos_cm": float(100 * np.linalg.norm(d[:3, 3])),
                "drot_deg": float(hp.rotation_angle_deg(d[:3, :3])),
                "bce_rel": float(abs(tr.metrics["sdf_bce"]
                                     - jr.metrics["sdf_bce"])
                                 / abs(jr.metrics["sdf_bce"])),
                "count_rel": abs(tn - jn) / jn,
                "valid": [bool(jr.tracking_valid), bool(tr.tracking_valid)]})
        gt = ds.gt_poses()
        ate = [absolute_error(s.poses, gt, align=False)["ate_trans_rmse_m"]
               for s in (js, ts)]
        whole = {"travel_cm": float(100 * np.max(np.abs(
                     np.subtract(ts.travel, js.travel)))),
                 "ate_m": ate, "ate_diff_cm": 100 * abs(ate[1] - ate[0])}
        print(json.dumps({"seed": seed, "frames": rows, **whole}),
              flush=True)
        keys = ("dpos_cm", "drot_deg", "bce_rel", "count_rel")
        cur = [{k: r[k] for k in keys} for r in rows]
        worst = cur if worst is None else [
            {k: max(a[k], b[k]) for k in keys} for a, b in zip(worst, cur)]
    print(json.dumps({"max_over_seeds": worst}))


if __name__ == "__main__":
    main()
