#!/usr/bin/env python3
"""Run one phase of ``chip_smoke.py`` alone on one GPU.

    python3 scripts/torch_smoke_phase.py parallel
    python3 scripts/torch_smoke_phase.py slam_loop [--runs 6]
    python3 scripts/torch_smoke_phase.py bench
    python3 scripts/torch_smoke_phase.py kitti_options [--runs 5]
    python3 scripts/torch_smoke_phase.py validation
    python3 scripts/torch_smoke_phase.py row_scatter

``parallel`` builds the kernels, ray-casts the kitti train cell's frames
112-121 and runs the smoke's ``parallel`` phase (groups of 1, 2 and 4 ranks
on the card); about 90 s of command time. ``slam_loop`` runs the
loop-closure phase on ``"60:circle"`` ``--runs`` times in one process, about
35 s each, and prints each run's outcome (a failed run does not stop the
others). ``bench`` runs ``python -m pings_tpu_torch.bench`` at full size
and holds and times the kernels on its tables (``chip_smoke.bench``).
``kitti_options`` writes the 12 kitti frames of ``cli kitti`` once and
runs the options cell (deskew, dynamic filter, semantics; every frame
must track) ``--runs`` times, about 60 s each. ``validation`` writes the
same 12 frames and runs the validation suite's kitti leg on them
(``chip_smoke.validation``). ``row_scatter`` prints the kernels' register
use and runs ``chip_smoke.row_scatter_check`` (the feature tables'
gradient scatter at the kitti shapes, held and timed). Exits non-zero if a
run failed.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", choices=("parallel", "slam_loop", "bench",
                                      "kitti_options", "validation",
                                      "row_scatter"))
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from pings_tpu_torch.data.synthetic import kitti_rig
    from pings_tpu_torch.ops import _build
    from pings_tpu_torch.ops import raster_blend as rb

    if not torch.cuda.is_available():
        print("torch_smoke_phase: needs a CUDA device", file=sys.stderr)
        return 1
    logs = _build.build_all()
    if args.phase == "row_scatter":
        for name, text in logs.items():
            for line in text.splitlines():
                if any(w in line for w in ("registers", "Compiling entry",
                                           "stack frame", "spill")):
                    print(f"  {name}: {line.strip()}", flush=True)
    if args.phase in ("kitti_options", "validation"):
        sys.path.insert(0, str(ROOT / "scripts"))
        from torch_make_kitti_data import make_kitti

        tmp = tempfile.mkdtemp(prefix="pings_phase_")
        make_kitti(tmp, 12, workers=min(8, os.cpu_count() or 1))
    failed = 0
    for k in range(args.runs):
        t0 = time.perf_counter()
        try:
            if args.phase == "parallel":
                T_c_l, K, _, _ = kitti_rig()
                fids = list(range(112, 122))
                frames, scan = cs.kitti_frames(fids + [122], fids[-1])
                cs.parallel(torch, {f: frames[f] for f in fids}, scan, T_c_l,
                            K, 40)
            elif args.phase == "bench":
                cs.bench(torch, rb)
            elif args.phase == "kitti_options":
                cs.kitti_options(torch, rb, os.path.join(tmp, "kitti_synth"))
            elif args.phase == "validation":
                cs.validation(os.path.join(tmp, "kitti_synth"))
            elif args.phase == "row_scatter":
                cs.row_scatter_check(torch)
            else:
                cs.slam_loop(torch, rb)
            print(f"run {k}: passed in {time.perf_counter() - t0:.1f} s",
                  flush=True)
        except AssertionError as e:
            failed += 1
            print(f"run {k}: failed in {time.perf_counter() - t0:.1f} s: {e}",
                  flush=True)
    if args.phase in ("kitti_options", "validation"):
        shutil.rmtree(tmp, ignore_errors=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
