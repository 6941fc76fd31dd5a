"""ctypes bindings of the port's host C++ library (``marching.cpp``).

A copy of ``pings_tpu/native/__init__.py`` (:33-109): ``marching_tetrahedra``
extracts an iso-surface from an SDF grid and ``nn_distances`` gives
grid-accelerated nearest-neighbour distances for mesh evaluation. Both
are host code in the JAX package too; neither is a device kernel.

The library is built at first use from ``marching.cpp`` beside this file
with ``$CXX`` (default ``g++``) and the flags of ``pings_tpu/native/Makefile``
into ``<repo>/build/libpings_native-<hash>.so``. The hash covers the
source, the compiler, the flags and what ``-march=native`` selects on this
machine, so a library built for another CPU is never loaded. A failed
build raises; there is no Python stand-in.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "marching.cpp"
BUILD = Path(__file__).resolve().parents[2] / "build"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
            "-shared"]

_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def lib_path() -> Path:
    """The library's path for this source, compiler, flags and CPU."""
    cxx = _cxx()
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True)
    key = (SRC.read_bytes() + cxx.encode() + " ".join(CXXFLAGS).encode()
           + target.stdout.encode())
    return BUILD / f"libpings_native-{hashlib.sha256(key).hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    proc = subprocess.run([_cxx(), *CXXFLAGS, "-o", tmp, str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SRC.name} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.marching_tetrahedra.restype = ctypes.c_int
    lib.marching_tetrahedra.argtypes = [
        f32p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float,
        f32p, i32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.nn_distances.restype = ctypes.c_int
    lib.nn_distances.argtypes = [
        f32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_float, f32p,
    ]
    _lib = lib
    return lib


def marching_tetrahedra(
    sdf: np.ndarray,
    origin,
    resolution: float,
    iso: float = 0.0,
    mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of sdf[(x,y,z)]. Returns (verts (V,3) f32,
    tris (T,3) i32)."""
    lib = get_lib()
    sdf = np.ascontiguousarray(sdf, np.float32)
    nx, ny, nz = sdf.shape
    flat = sdf.reshape(-1)
    mask_ptr = None
    if mask is not None:
        mask_arr = np.ascontiguousarray(mask.reshape(-1), np.uint8)
        if mask_arr.size != flat.size:
            raise ValueError(f"mask has {mask_arr.size} entries, the grid "
                             f"{flat.size}")
        mask_ptr = mask_arr.ctypes.data_as(ctypes.c_void_p)
    # generous initial caps; retry doubled on overflow
    max_v = max(1 << 16, int(flat.size * 0.5))
    for _ in range(4):
        max_t = 2 * max_v
        verts = np.empty((max_v, 3), np.float32)
        tris = np.empty((max_t, 3), np.int32)
        nv = ctypes.c_int32(0)
        nt = ctypes.c_int32(0)
        ret = lib.marching_tetrahedra(
            flat, mask_ptr, nx, ny, nz, float(iso),
            float(origin[0]), float(origin[1]), float(origin[2]),
            float(resolution),
            verts.reshape(-1), tris.reshape(-1),
            max_v, max_t, ctypes.byref(nv), ctypes.byref(nt))
        if ret == 0:
            return verts[: nv.value].copy(), tris[: nt.value].copy()
        max_v *= 2
    return verts[: nv.value].copy(), tris[: nt.value].copy()


def nn_distances(query: np.ndarray, ref: np.ndarray,
                 cell: float = 0.2) -> np.ndarray:
    """For each query point, distance to the nearest ref point (capped at
    ~3*cell search radius; farther points report 1e9)."""
    lib = get_lib()
    q = np.ascontiguousarray(query, np.float32).reshape(-1, 3)
    r = np.ascontiguousarray(ref, np.float32).reshape(-1, 3)
    out = np.empty(len(q), np.float32)
    lib.nn_distances(q.reshape(-1), len(q), r.reshape(-1), len(r),
                     float(cell), out)
    return out
