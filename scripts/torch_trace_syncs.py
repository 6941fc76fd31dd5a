#!/usr/bin/env python3
"""Hold the port's ``host_reads`` counter against the synchronizing CUDA
calls that ``torch.cuda.set_sync_debug_mode("warn")`` reports, over
traced kitti frames and traced serve views on the card.

    python3 scripts/torch_trace_syncs.py [--frames 2] [--views 3] \
        [--seed 7] [--out trace_syncs.json]

Set-up is the benchmark's own (``perfbench/harness``): the
``kitti_lidar.slam`` cell maps its warm frames, the ``replica_rgbd.serve``
cell loads its map and warms its views. Then, with the span recorder on
(``pings_tpu_torch.utils.trace.enable``) and the sync debug mode at
"warn", each frame runs through ``process_frame`` and each view through
the serve harness's local mask and ``render_cam``. Every warning is
recorded with the line that made the call and the innermost span the
recorder had open there; a warning from outside the program (the harness)
is listed apart. A warning whose innermost span is not a ``read/<site>``
span is a wait the program does not count. The result (sites, counts,
uncovered waits) is printed and written to ``--out``; the exit code is 1
where any frame or view has uncovered waits or a count that differs from
its warnings. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PROGRAM = "pings_tpu_torch"


def site_of(stack):
    """(``file:line (function)`` of the frame that made the call, whether
    that frame is the program's) from a stack taken inside the warning:
    the innermost frame outside torch, the warnings machinery, the
    recorder and this script."""
    skip = ("/torch/", "/warnings.py", "utils/trace.py",
            "torch_trace_syncs.py")
    for f in reversed(stack):
        if not any(k in f.filename for k in skip):
            name = f.filename.split(PROGRAM + "/")[-1]
            return f"{name}:{f.lineno} ({f.name})", PROGRAM in f.filename
    return "?", False


def run_synced(torch, trace, fn):
    """Run ``fn()`` with the sync debug mode at "warn"; returns the
    program's warnings as (site, innermost open span) pairs and the count
    of the others."""
    seen, others = [], []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        site, ours = site_of(traceback.extract_stack())
        if ours:
            span = trace.open_span_name() if trace is not None else None
            seen.append((site, span))
        else:
            others.append(site)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return seen, others


def summarize(kind, root_reads, synced) -> dict:
    seen, others = synced
    uncovered = [s for s in seen if not (s[1] or "").startswith("read/")]
    return {"kind": kind, "host_reads": root_reads, "warnings": len(seen),
            "outside_the_program": sorted(Counter(others).items()),
            "uncovered": len(uncovered),
            "sites": sorted(Counter(s[0] for s in seen).items()),
            "uncovered_sites": sorted(Counter(
                f"{s[0]} in {s[1]}" for s in uncovered).items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--views", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default="trace_syncs.json")
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import common
    from perfbench.run import harness_for

    if not torch.cuda.is_available():
        print("torch_trace_syncs: needs a CUDA device", file=sys.stderr)
        return 2
    try:
        from pings_tpu_torch.utils import trace
    except ImportError:          # a checkout without the recorder
        trace = None
    common.set_cache_dirs()
    dev = torch.device("cuda:0")
    print(f"card: {common.card_line()}", flush=True)
    results = []

    def roots_of(name):
        return [r for r in trace.roots() if r.name == name] if trace else []

    def reads(root):
        return root.counters.get("host_reads", 0)

    # kitti: frames after the warm ones, through process_frame
    cell = common.cell("kitti_lidar.slam")
    d = harness_for(cell)(torch, cell, args.seed, 8.0, dev)
    d.setup()
    fid = d.warm
    for _ in range(args.frames):
        if trace:
            trace.reset()
            trace.enable()
        frame = d.frames[fid]
        synced = run_synced(torch, trace, lambda: (
            d.system.process_frame(frame), torch.cuda.synchronize()))
        if trace:
            trace.disable()
        pf = roots_of("process_frame")
        results.append(summarize(f"frame {fid}", sum(map(reads, pf)),
                                 synced))
        fid += 1
    d.free_program()
    del d
    torch.cuda.empty_cache()

    # serve: views after the warm ones, as the serve harness renders them
    cell = common.cell("replica_rgbd.serve")
    s = harness_for(cell)(torch, cell, args.seed, 8.0, dev)
    s.setup()
    for i in range(s.warm, s.warm + args.views):
        if trace:
            trace.reset()
            trace.enable()
        synced = run_synced(torch, trace, lambda: (
            s._view(i), torch.cuda.synchronize()))
        if trace:
            trace.disable()
        n = sum(reads(r) for name in ("local_mask", "render_cam")
                for r in roots_of(name))
        results.append(summarize(f"view {i}", n, synced))

    bad = 0
    for r in results:
        ok = r["uncovered"] == 0 and r["host_reads"] == r["warnings"]
        bad += not ok
        print(f"{r['kind']}: host_reads {r['host_reads']}, sync warnings "
              f"{r['warnings']}, uncovered {r['uncovered']} "
              f"{'ok' if ok else 'DIFFERS'}")
        for site, n in r["sites"]:
            print(f"    {n:4d}  {site}")
        for site, n in r["uncovered_sites"]:
            print(f"    uncovered {n:4d}  {site}")
        for site, n in r["outside_the_program"]:
            print(f"    outside the program {n:4d}  {site}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": common.card_line(),
                               "results": results}, indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
