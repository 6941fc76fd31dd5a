#!/usr/bin/env python3
"""Write the synthetic replica room as a Replica RGB-D sequence, with the
port alone (numpy; no JAX, no OpenCV).

    python3 scripts/torch_make_replica_data.py [OUT_DIR] [--poses N]
        [--frames F] [--texture checker|smooth] [--workers W]

writes ``OUT_DIR/replica_synth/room_synth/`` (default ``OUT_DIR`` =
``data_validation``; ``replica_synth_smooth`` for the smooth texture):
``results/rgb%06d.png`` (8-bit RGB, lossless), ``results/depth%06d.png``
(uint16, metres x 6553.5) and ``traj.txt`` (one flattened camera-to-world
4x4 per line), the layout ``ReplicaDataset`` reads. The room, camera and
orbit are those of ``make_replica`` in ``scripts/make_validation_data.py``
(:82-115), on ``pings_tpu_torch/data/synthetic.py``'s ``room_world`` and
``render_pinhole``; that writer stores JPEG colour frames, this one PNG.

Pose i of the orbit depends on N (its angle is 2 pi i / N * 0.75), so
``--frames F`` writes only the first F of N frames and keeps the
trajectory of a full N-frame run (``traj.txt`` holds the F poses written).
``W`` processes ray-cast the frames (about 1.6 s a frame for one process).
Then ``python -m pings_tpu_torch configs/replica_synth.yaml --no-track
--data-path OUT_DIR/replica_synth`` runs on it.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pings_tpu_torch.data.imageio import write_png  # noqa: E402
from pings_tpu_torch.data.synthetic import (  # noqa: E402
    render_pinhole, room_world)
from pings_tpu_torch.utils.pose import so3_exp  # noqa: E402

K = np.array([[600.0, 0, 599.5], [0, 600.0, 339.5], [0, 0, 1]])
WIDTH, HEIGHT = 1200, 680
DEPTH_SCALE = 6553.5


def replica_pose(i: int, n_poses: int) -> np.ndarray:
    """Camera-to-world pose ``i`` of the ``n_poses``-frame orbit."""
    ang = 2 * np.pi * i / max(n_poses, 1) * 0.75
    eye = np.array([1.8 * np.cos(ang), 1.5 * np.sin(ang), 1.4])
    yaw = ang + np.pi / 2 * 0.6 + 0.3 * np.sin(2 * ang)
    R_wc = so3_exp(np.array([0, 0, yaw])) @ \
        so3_exp(np.array([0.12, 0, 0])) @ \
        np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    T_w_c = np.eye(4)
    T_w_c[:3, :3] = R_wc
    T_w_c[:3, 3] = eye
    return T_w_c


def _write_frame(res: str, i: int, n_poses: int, texture: str) -> None:
    img, depth = render_pinhole(replica_pose(i, n_poses), K, WIDTH, HEIGHT,
                                room_world(texture))
    # "Up" filter: compact and read back row-vectorised
    write_png(os.path.join(res, f"rgb{i:06d}.png"), img, filter_type=2)
    d16 = np.clip(depth * DEPTH_SCALE, 0, 65535).astype(np.uint16)
    write_png(os.path.join(res, f"depth{i:06d}.png"), d16, filter_type=2)


def make_replica(out_dir: str, n_poses: int = 60,
                 n_frames: int | None = None, texture: str = "checker",
                 workers: int = 1) -> str:
    """Write the first ``n_frames`` (default all) of ``n_poses`` frames
    with ``workers`` processes; returns the sequence directory."""
    n_frames = n_poses if n_frames is None else n_frames
    if not 0 < n_frames <= n_poses:
        raise ValueError(f"--frames {n_frames} must be in 1..{n_poses}")
    name = ("replica_synth" if texture == "checker"
            else f"replica_synth_{texture}")
    seq = os.path.join(out_dir, name, "room_synth")
    res = os.path.join(seq, "results")
    os.makedirs(res, exist_ok=True)
    args = ([res] * n_frames, range(n_frames), [n_poses] * n_frames,
            [texture] * n_frames)
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as ex:
            list(ex.map(_write_frame, *args))
    else:
        for a in zip(*args):
            _write_frame(*a)
    np.savetxt(os.path.join(seq, "traj.txt"),
               np.stack([replica_pose(i, n_poses).reshape(-1)
                         for i in range(n_frames)]))
    return seq


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default="data_validation")
    ap.add_argument("--poses", type=int, default=60,
                   help="frames of the whole orbit (N)")
    ap.add_argument("--frames", type=int, default=None,
                   help="write only the first F <= N frames")
    ap.add_argument("--texture", choices=("checker", "smooth"),
                   default="checker")
    ap.add_argument("--workers", type=int, default=1)
    args = ap.parse_args(argv)
    seq = make_replica(args.out_dir, args.poses, args.frames, args.texture,
                       args.workers)
    print(f"replica: {args.frames or args.poses} of {args.poses} frames "
          f"-> {seq}")
    return seq


if __name__ == "__main__":
    main()
