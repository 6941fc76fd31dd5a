#!/usr/bin/env python3
"""Read a cell's compared numbers over several seeds in one process: the
program's (the lower readings of the limits), the control's (the
reference on TF32 inputs in the program's place: the upper
readings) and, with ``--faults``, those of the program with faults
planted in its timed path.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--faults half_batch+tracker_unchanged,sdf_unchanged]

``--faults`` lists sets of faults, each planted alone (``+`` joins
faults planted together): one run per seed and set. One JSON line per
run on standard output. The benchmark's own runs (``run.py``) never run
the control or a fault.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run as bench  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default="")
    a = ap.parse_args(argv)
    sets = [tuple(f.split("+")) for f in a.faults.split(",") if f] or [()]
    import torch

    for seed, faults in ((int(s), f) for s in a.seeds.split(",")
                         for f in sets):
        args = bench.parse(["--workload", a.workload, "--seed", str(seed),
                            "--seconds", str(a.seconds), "--trace", "0"])
        t0 = time.time()
        result, checks = bench.run(args, faults=faults, t_process=t0,
                                   control=not faults)
        print(json.dumps({"seed": seed, "faults": list(faults),
                          "correct": result["correct"],
                          "failed": result["failed"],
                          "attempted": result["attempted"],
                          "program": {c["name"]: c["value"] for c in checks},
                          "control": result.get("control")}), flush=True)
        del result, checks
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
