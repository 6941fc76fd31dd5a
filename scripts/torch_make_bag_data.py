#!/usr/bin/env python3
"""Write the scans of a KITTI-format sequence into a ROS1 bag and a
CDR-encoded MCAP, with the port alone (numpy; no JAX, no ROS).

    python3 scripts/torch_make_bag_data.py SEQ_DIR OUT_DIR [--frames N]
        [--topic /velodyne_points]

reads ``SEQ_DIR/velodyne/%06d.bin`` (as ``scripts/torch_make_kitti_data.py``
writes them, with ``--skew`` for a sweep that needs deskewing) and writes
``OUT_DIR/kitti_synth.bag`` (ROS bag 2.0, one uncompressed chunk, a
connection record and one ``sensor_msgs/PointCloud2`` message per scan) and
``OUT_DIR/kitti_synth.mcap`` (a schema, a channel and one
``sensor_msgs/msg/PointCloud2`` message per scan, CDR little-endian). Each
point carries x, y, z, intensity and ``t``, its time in seconds after the
scan's stamp: the kitti loader's sweep fraction ((pi - azimuth) / 2 pi)
times the 0.1 s period. Scan i is stamped 10 + 0.1 i s. The writers follow
the format specs (http://wiki.ros.org/Bags/Format/2.0, https://mcap.dev/spec)
as the readers in ``pings_tpu_torch/data/bag_formats.py`` read them.
``python -m pings_tpu_torch CONFIG --loader rosbag --data-path
OUT_DIR/kitti_synth.bag`` (or ``--loader mcap ... .mcap``) then maps them.
"""

from __future__ import annotations

import argparse
import glob
import os
import struct

import numpy as np

PERIOD_S = 0.1
FIELDS = [(b"x", 0), (b"y", 4), (b"z", 8), (b"intensity", 12), (b"t", 16)]
FLOAT32 = 7                     # sensor_msgs/PointField datatype


def scan_records(path: str) -> np.ndarray:
    """(N, 5) float32 rows x, y, z, intensity, t of a KITTI .bin scan."""
    raw = np.fromfile(path, np.float32).reshape(-1, 4)
    az = np.arctan2(raw[:, 1], raw[:, 0])
    frac = ((-az + np.pi) / (2 * np.pi)).astype(np.float32)
    return np.concatenate([raw, (frac * np.float32(PERIOD_S))[:, None]],
                          1).astype(np.float32)


def stamp(i: int):
    ns = 10 * 10 ** 9 + i * int(PERIOD_S * 1e9)
    return ns // 10 ** 9, ns % 10 ** 9, ns


# -- ROS1 bag ---------------------------------------------------------------

def _string(s: bytes) -> bytes:
    return struct.pack("<I", len(s)) + s


def _header(**fields) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _record(header: bytes, data: bytes) -> bytes:
    return (struct.pack("<I", len(header)) + header
            + struct.pack("<I", len(data)) + data)


def ros1_pointcloud2(rows: np.ndarray, sec: int, nsec: int) -> bytes:
    n = len(rows)
    body = struct.pack("<III", 0, sec, nsec) + _string(b"velodyne")
    body += struct.pack("<II", 1, n) + struct.pack("<I", len(FIELDS))
    for name, off in FIELDS:
        body += _string(name) + struct.pack("<IBI", off, FLOAT32, 1)
    step = 4 * len(FIELDS)
    body += struct.pack("<BII", 0, step, step * n)
    return body + _string(rows.tobytes()) + struct.pack("<B", 1)


def write_bag(path: str, scans, topic: bytes) -> None:
    conn = struct.pack("<I", 0)
    records = _record(
        _header(op=b"\x07", conn=conn, topic=topic),
        _header(topic=topic, type=b"sensor_msgs/PointCloud2",
                md5sum=b"1158d486dd51d683ce2f1be655c3c181",
                message_definition=b""))
    for i, rows in enumerate(scans):
        sec, nsec, _ = stamp(i)
        records += _record(
            _header(op=b"\x02", conn=conn, time=struct.pack("<II", sec,
                                                            nsec)),
            ros1_pointcloud2(rows, sec, nsec))
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_record(_header(
            op=b"\x03", index_pos=struct.pack("<Q", 0),
            conn_count=struct.pack("<I", 1),
            chunk_count=struct.pack("<I", 1)), b" " * 64))
        f.write(_record(_header(
            op=b"\x05", compression=b"none",
            size=struct.pack("<I", len(records))), records))


# -- MCAP with CDR messages -------------------------------------------------

def cdr_pointcloud2(rows: np.ndarray, sec: int, nsec: int) -> bytes:
    buf = bytearray(b"\x00\x01\x00\x00")      # CDR little-endian

    def align(n):
        rem = (len(buf) - 4) % n
        if rem:
            buf.extend(b"\x00" * (n - rem))

    def u32(v):
        align(4)
        buf.extend(struct.pack("<I", v))

    def string(s):
        u32(len(s) + 1)
        buf.extend(s + b"\x00")

    u32(sec)
    u32(nsec)
    string(b"velodyne")
    u32(1)
    u32(len(rows))
    u32(len(FIELDS))
    for name, off in FIELDS:
        string(name)
        u32(off)
        buf.append(FLOAT32)
        u32(1)
    buf.append(0)                               # is_bigendian
    step = 4 * len(FIELDS)
    u32(step)
    u32(step * len(rows))
    raw = rows.tobytes()
    u32(len(raw))
    buf.extend(raw)
    buf.append(1)                               # is_dense
    return bytes(buf)


def _mcap_record(op: int, payload: bytes) -> bytes:
    return struct.pack("<BQ", op, len(payload)) + payload


def write_mcap(path: str, scans, topic: bytes) -> None:
    recs = _mcap_record(0x03, struct.pack("<H", 1)
                        + _string(b"sensor_msgs/msg/PointCloud2")
                        + _string(b"ros2msg") + struct.pack("<I", 0))
    recs += _mcap_record(0x04, struct.pack("<HH", 1, 1) + _string(topic)
                         + _string(b"cdr") + struct.pack("<I", 0))
    for i, rows in enumerate(scans):
        sec, nsec, ns = stamp(i)
        recs += _mcap_record(0x05, struct.pack("<HIQQ", 1, i, ns, ns)
                             + cdr_pointcloud2(rows, sec, nsec))
    with open(path, "wb") as f:
        f.write(b"\x89MCAP0\r\n")
        f.write(_mcap_record(0x01, _string(b"") + _string(b"")))
        f.write(recs)
        f.write(_mcap_record(0x02, struct.pack("<QQI", 0, 0, 0)))
        f.write(b"\x89MCAP0\r\n")


def make_bags(seq_dir: str, out_dir: str, n_frames: int = 0,
              topic: str = "/velodyne_points"):
    """Write both files; returns (bag path, mcap path)."""
    files = sorted(glob.glob(os.path.join(seq_dir, "velodyne", "*.bin")))
    if n_frames:
        files = files[:n_frames]
    if not files:
        raise FileNotFoundError(f"no velodyne/*.bin under {seq_dir}")
    scans = [scan_records(f) for f in files]
    os.makedirs(out_dir, exist_ok=True)
    bag = os.path.join(out_dir, "kitti_synth.bag")
    mcap = os.path.join(out_dir, "kitti_synth.mcap")
    write_bag(bag, scans, topic.encode())
    write_mcap(mcap, scans, topic.encode())
    return bag, mcap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seq_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=0,
                    help="the first N scans (default all)")
    ap.add_argument("--topic", default="/velodyne_points")
    args = ap.parse_args(argv)
    bag, mcap = make_bags(args.seq_dir, args.out_dir, args.frames,
                          args.topic)
    print(f"{bag}, {mcap}")
    return bag, mcap


if __name__ == "__main__":
    main()
