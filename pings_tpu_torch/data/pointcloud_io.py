"""Point-cloud file IO (PCD / PLY, ascii + binary) without Open3D.

A copy of ``pings_tpu/data/pointcloud_io.py`` (numpy only).

The reference leans on Open3D for .pcd/.ply reading (e.g.
dataset/dataloaders/apollo.py:56, ncd.py via pyntcloud); this module
implements the two formats directly with numpy structured dtypes so the
data layer has no native-viewer dependency.

Returned dict: {"xyz": (N,3) f32, optional "rgb": (N,3) f32 in [0,1],
"intensity": (N,) f32, "time": (N,) f32, "ring": (N,) i32} — whatever
fields the file carries.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

_PCD_TYPE = {("F", 4): "<f4", ("F", 8): "<f8",
             ("I", 1): "<i1", ("I", 2): "<i2", ("I", 4): "<i4",
             ("I", 8): "<i8",
             ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4",
             ("U", 8): "<u8"}

_PLY_TYPE = {"char": "<i1", "int8": "<i1", "uchar": "<u1", "uint8": "<u1",
             "short": "<i2", "int16": "<i2", "ushort": "<u2",
             "uint16": "<u2", "int": "<i4", "int32": "<i4",
             "uint": "<u4", "uint32": "<u4", "float": "<f4",
             "float32": "<f4", "double": "<f8", "float64": "<f8"}

# aliases for auxiliary per-point fields
_TIME_FIELDS = ("time", "t", "timestamp", "time_offset", "point_time",
                "stamps", "ts")
_INTENSITY_FIELDS = ("intensity", "i", "reflectivity")


def _assemble(arr: np.ndarray, names) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    low = {n.lower(): n for n in names}

    def col(n):
        return np.asarray(arr[low[n]])

    if all(k in low for k in ("x", "y", "z")):
        out["xyz"] = np.stack(
            [col("x"), col("y"), col("z")], axis=-1).astype(np.float32)
    if all(k in low for k in ("red", "green", "blue")):
        rgb = np.stack([col("red"), col("green"), col("blue")], axis=-1)
        out["rgb"] = rgb.astype(np.float32) / (
            255.0 if rgb.dtype.kind in "iu" else 1.0)
    elif "rgb" in low:
        packed = col("rgb")
        iv = packed.view(np.uint32) if packed.dtype.kind == "f" \
            else packed.astype(np.uint32)
        out["rgb"] = np.stack([(iv >> 16) & 255, (iv >> 8) & 255,
                               iv & 255], axis=-1).astype(np.float32) / 255.0
    for k in _TIME_FIELDS:
        if k in low:
            out["time"] = col(k).astype(np.float64)
            break
    for k in _INTENSITY_FIELDS:
        if k in low:
            out["intensity"] = col(k).astype(np.float32)
            break
    if "ring" in low:
        out["ring"] = col("ring").astype(np.int32)
    return out


def read_pcd(path: str) -> Dict[str, np.ndarray]:
    """Read a .pcd file (ascii or binary; binary_compressed unsupported)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        dtype = []
        for name, t, s, c in zip(fields, types, sizes, counts):
            base = _PCD_TYPE[(t, s)]
            if c == 1:
                dtype.append((name, base))
            else:
                dtype.append((name, base, (c,)))
        dtype = np.dtype(dtype)
        mode = header["DATA"].split()[0]
        if mode == "ascii":
            arr = np.loadtxt(f, dtype=dtype, max_rows=n)
        elif mode == "binary":
            arr = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype,
                                count=n)
        else:
            raise ValueError(f"unsupported PCD DATA mode '{mode}' in {path}")
    return _assemble(arr, arr.dtype.names)


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the vertex element of a .ply (ascii or binary little-endian)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elems = []              # (name, count, [(prop, type), ...])
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if line.startswith("comment") or not line:
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                elems.append((name, int(cnt), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elems[-1][2].append((parts[-1], "list", parts[2],
                                         parts[3]))
                else:
                    elems[-1][2].append((parts[2], parts[1]))
            elif line == "end_header":
                break
        if fmt == "binary_big_endian":
            raise ValueError("big-endian PLY unsupported")
        out = None
        for name, cnt, props in elems:
            if name == "vertex":
                dtype = np.dtype([(p[0], _PLY_TYPE[p[1]]) for p in props])
                if fmt == "ascii":
                    arr = np.loadtxt(f, dtype=dtype, max_rows=cnt)
                else:
                    arr = np.frombuffer(f.read(cnt * dtype.itemsize),
                                        dtype=dtype, count=cnt)
                out = _assemble(arr, arr.dtype.names)
            else:
                # skip non-vertex elements (only possible pre-vertex in
                # ascii by line count; binary lists have variable size)
                if fmt == "ascii":
                    for _ in range(cnt):
                        f.readline()
                elif any(p[1] == "list" for p in props):
                    if out is not None:
                        break      # vertex data already read; done
                    raise ValueError(
                        "PLY with list elements before vertex unsupported")
                else:
                    dtype = np.dtype([(p[0], _PLY_TYPE[p[1]])
                                      for p in props])
                    f.seek(cnt * dtype.itemsize, 1)
        if out is None:
            raise ValueError(f"no vertex element in {path}")
        return out


def read_points_any(path: str) -> Dict[str, np.ndarray]:
    """Dispatch by extension; also handles .bin (KITTI xyzi) and .npy."""
    low = path.lower()
    if low.endswith(".pcd"):
        return read_pcd(path)
    if low.endswith(".ply"):
        return read_ply(path)
    if low.endswith(".bin"):
        raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        return {"xyz": raw[:, :3], "intensity": raw[:, 3]}
    if low.endswith(".npy"):
        raw = np.load(path)
        out = {"xyz": raw[:, :3].astype(np.float32)}
        if raw.shape[1] >= 6:
            out["rgb"] = raw[:, 3:6].astype(np.float32)
        elif raw.shape[1] >= 4:
            out["intensity"] = raw[:, 3].astype(np.float32)
        return out
    raise ValueError(f"unknown point-cloud format: {path}")


def write_ply_points(path: str, pts: np.ndarray,
                     colors: np.ndarray = None) -> None:
    """Binary PLY point-cloud writer (xyz [+ uchar rgb]). Counterpart of
    the reference's o3d.io.write_point_cloud for the merged-cloud output
    (slam_dataset.py:995-1195)."""
    n = len(pts)
    with_rgb = colors is not None and len(colors) == n
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if with_rgb:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    if with_rgb:
        dt = np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
        rec = np.empty(n, dt)
        rec["xyz"] = pts.astype(np.float32)
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = (np.clip(c, 0, 1) * 255).astype(np.uint8)
        rec["rgb"] = c
    else:
        dt = np.dtype([("xyz", np.float32, 3)])
        rec = np.empty(n, dt)
        rec["xyz"] = pts.astype(np.float32)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        rec.tofile(f)
