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

With ``--kitti DIR`` the same comparison runs on frames that
``scripts/torch_make_kitti_data.py`` wrote under DIR, at
``configs/kitti_synth.yaml`` with the pose graph off, GS off unless
``--set gs_on=true``, and each ``--set KEY=VALUE`` applied (for example
the options ``deskew``, ``dynamic_filter_on`` and ``semantic_on`` on
``--skew --labels`` frames), the port again from the JAX package's
decoders and draws (the joint step's SDF batches too); each frame also
gives both trackers' iterations and both position errors against the
ground truth (cm). On the CPU the JAX package renders through its XLA
blend, which gives no contributions: with GS on, set
``lambda_gs_sdf_consist`` and ``lambda_gs_sdf_normal_consist`` to 0 so
that both packages train the same loss:

    python3 tests/torch_slam_parity_sweep.py --seeds 42 --kitti DIR \
        --set deskew=true --set dynamic_filter_on=true \
        --set semantic_on=true

It imports both packages, like the tests beside it, and runs JAX on the
CPU; about 80 s a seed (about 7 minutes a seed on 12 kitti frames).
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
import yaml  # noqa: E402

from pings_tpu.utils import pose as hp  # noqa: E402
from pings_tpu_torch.eval.traj import absolute_error  # noqa: E402
from torch_slam_helpers import (  # noqa: E402
    JaxDraws, decoders_to_torch, run_slice)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_kitti(data: str, n: int, seed: int, sets: dict):
    """``run_slice``'s comparison on the first ``n`` kitti frames under
    ``data`` (``configs/kitti_synth.yaml``, pose graph off, GS off unless
    ``sets`` turns it on)."""
    from pings_tpu.config import Config as JConfig
    from pings_tpu.data.base import dataset_factory
    from pings_tpu.slam.pipeline import SlamSystem as JSlam
    from pings_tpu_torch.config import Config as TConfig
    from pings_tpu_torch.slam.pipeline import SlamSystem as TSlam

    path = os.path.join(ROOT, "configs", "kitti_synth.yaml")
    over = dict({"gs_on": False, **sets}, pgo_on=False, seed=seed)
    jcfg, tcfg = JConfig.load(path, overrides=over), TConfig.load(
        path, overrides=over)
    ds = dataset_factory(jcfg.data_loader_name, data, jcfg.data_loader_seq,
                         jcfg)
    js = JSlam(jcfg)
    ts = TSlam(tcfg, device="cpu")
    ts.decoders = decoders_to_torch(js.decoders)
    ts.draws = JaxDraws(tcfg)
    out, gt = [], []
    for i in range(min(n, len(ds))):
        f = ds[i]
        jr, tr = js.process_frame(f), ts.process_frame(f)
        gt.append(f["gt_pose"])
        out.append((jr, tr, js.poses[-1].copy(), ts.poses[-1].copy(),
                    int(js.m.count), int(ts.m.count)))
    return out, gt, js, ts


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="42,0,1,2,3,4,5")
    ap.add_argument("--kitti", default=None, metavar="DIR",
                    help="frames of scripts/torch_make_kitti_data.py")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE")
    args = ap.parse_args()
    sets = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        sets[k] = yaml.safe_load(v)
    torch.set_num_threads(1)    # as the tests' ``one_torch_thread``
    worst = None
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        if args.kitti:
            out, gt, js, ts = run_kitti(args.kitti, args.frames, seed, sets)
        else:
            out, _, ds, js, ts = run_slice(seed=seed)
            gt = ds.gt_poses()
        rows = []
        for i, (jr, tr, jT, tT, jn, tn) in enumerate(out):
            d = hp.se3_inv(jT) @ tT
            rows.append({
                "dpos_cm": float(100 * np.linalg.norm(d[:3, 3])),
                "drot_deg": float(hp.rotation_angle_deg(d[:3, :3])),
                "bce_rel": float(abs(tr.metrics["sdf_bce"]
                                     - jr.metrics["sdf_bce"])
                                 / abs(jr.metrics["sdf_bce"])),
                "count_rel": abs(tn - jn) / jn,
                "valid": [bool(jr.tracking_valid), bool(tr.tracking_valid)]})
            if args.kitti:
                rows[-1]["track_iter"] = [jr.metrics.get("track_iter"),
                                          tr.metrics.get("track_iter")]
                rows[-1]["gt_err_cm"] = [
                    float(100 * np.linalg.norm(T[:3, 3] - gt[i][:3, 3]))
                    for T in (jT, tT)]
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
