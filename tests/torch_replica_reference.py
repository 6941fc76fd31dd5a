#!/usr/bin/env python3
"""The JAX package's numbers on the committed replica map, which
``chip_smoke.py``'s ``replica eval`` phase holds the port's against.

    python3 scripts/torch_make_replica_data.py DIR --workers 4
    python3 tests/torch_replica_reference.py DIR/replica_synth

On the frames that the port's writer made (PNG colour, so both packages
read the same pixels): the JAX package's ``eval_heldout``
(``pings_tpu/inspect_map.py:154``) on
``runs_validation/replica_synth_20260822_050419`` with
``raster_precision="high"`` and ``--eval-every 5`` (per split the mean
PSNR, SSIM, ``lpips_rand`` and depth L1), and the vertex count of its
``Mesher.recon_map_mesh`` at the run's ``mc_res_m`` (0.2 m) and at 0.05 m.
Prints one JSON line.
It imports both packages, like the tests beside it, and runs JAX on the
CPU (about 15 s a full-size view).
"""

import argparse
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


REPLICA = os.path.join(ROOT, "runs_validation",
                       "replica_synth_20260822_050419")


def eval_args(data_path, eval_every=5):
    return argparse.Namespace(loader="replica", data_path=data_path,
                              seq="room_synth", eval_every=eval_every,
                              cam_refine=False)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data_path", help="DIR/replica_synth of the writer")
    ap.add_argument("--out", default=None,
                    help="where gs_eval.csv goes (default: a temporary "
                         "directory)")
    args = ap.parse_args()
    import tempfile

    from pings_tpu import inspect_map as im
    from pings_tpu.slam.mesher import Mesher

    out = args.out or tempfile.mkdtemp(prefix="jax_replica_ref_")
    os.makedirs(out, exist_ok=True)
    cfg, system = im.load_system(REPLICA)
    cfg.raster_precision = "high"
    t0 = time.perf_counter()
    summary = im.eval_heldout(eval_args(args.data_path), cfg, system, out)
    t_eval = time.perf_counter() - t0
    summary.update({"eval_s": t_eval, "out": out})
    for res in (cfg.mc_res_m, 0.05):
        t0 = time.perf_counter()
        v, t, _ = Mesher(cfg).recon_map_mesh(system.m, system.decoders,
                                             res=res)
        summary[f"mesh_{res}"] = {"verts": len(v), "tris": len(t),
                                  "s": time.perf_counter() - t0}
    print(json.dumps(summary, default=float))


if __name__ == "__main__":
    main()
