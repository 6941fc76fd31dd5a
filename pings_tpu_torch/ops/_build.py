"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``<repo>/build/lib<name>-<hash>.so`` at first
use, then loaded with ``ctypes``. The file name carries a hash of the
source, of the headers beside it (``csrc/*.cuh``) and of the flags, so an
edited kernel is rebuilt and a stale library is never loaded. ``build_all``
starts one ``nvcc`` per source, all at once, and waits for them.

``-fmad=false`` keeps the compiler from contracting a multiply and an add
into one fused operation, so each kernel rounds as its plain PyTorch
version does (eager PyTorch runs one operation per launch); the kernels'
gate tests (``q < 9``, ``alpha >= 1/255``) then agree with the plain
version bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
KERNELS = ("blend_fwd", "blend_bwd", "blend_contrib")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise FileNotFoundError("nvcc not found (set CUDA_HOME)")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{h}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library exists; returns the
    running process and its paths, or None."""
    out = lib_path(name)
    if out.exists():
        return None
    nvcc = nvcc_path()
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel source in parallel; returns each one's
    compiler output (register and shared-memory use), empty for a
    library that was already built. Waits for every compiler before it
    raises for any that failed."""
    jobs = {n: _start(n) for n in names}
    logs, failed = {}, []
    for name, job in jobs.items():
        if job is None:
            logs[name] = ""
            continue
        proc, tmp, out = job
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return _LIBS[name]
