#!/usr/bin/env python3
"""Write the validation sequences in the real datasets' on-disk formats,
with the port alone (numpy; no JAX, no OpenCV).

Counterpart of ``scripts/make_validation_data.py``, with its arguments and
its directory layout:

- ``OUT_DIR/replica_synth/room_synth/`` (``replica_synth_smooth`` for
  ``--texture smooth``): the indoor room at 1200x680 in the Replica layout,
  written by ``scripts/torch_make_replica_data.make_replica``. Colour
  frames are lossless PNG (``results/rgb%06d.png``) where the JAX writer
  stores JPEG at quality 97 (``results/frame%06d.jpg``): the card's machine
  has no OpenCV. The held-out PSNR of a replica run moves with this.
- ``OUT_DIR/kitti_synth/00/``: the ~254 m stadium circuit scanned by a
  64-beam LiDAR with one 640x240 camera, in the KITTI odometry layout,
  written by ``scripts/torch_make_kitti_data.make_kitti``.

``scripts/torch_run_validation.py`` runs the port on them.

Usage: python3 scripts/torch_make_validation_data.py [out_dir]
           [--frames-replica N] [--frames-kitti N] [--only replica|kitti]
           [--texture checker|smooth] [--workers W]
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from torch_make_kitti_data import make_kitti  # noqa: E402
from torch_make_replica_data import make_replica  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default="data_validation")
    ap.add_argument("--frames-replica", type=int, default=60)
    ap.add_argument("--frames-kitti", type=int, default=250)
    ap.add_argument("--only", choices=("replica", "kitti"), default=None)
    ap.add_argument("--texture", choices=("checker", "smooth"),
                    default="checker",
                    help="replica room texture (smooth = the SSIM "
                         "texture-statistics experiment variant)")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes that ray-cast the frames")
    args = ap.parse_args(argv)
    if args.only in (None, "replica"):
        seq = make_replica(args.out_dir, args.frames_replica,
                           texture=args.texture, workers=args.workers)
        print(f"replica_synth: {args.frames_replica} frames -> {seq}")
    if args.only in (None, "kitti"):
        seq = make_kitti(args.out_dir, args.frames_kitti,
                         workers=args.workers)
        print(f"kitti_synth: {args.frames_kitti} frames -> {seq}")


if __name__ == "__main__":
    main()
