"""Build the port's CUDA sources into one shared library and load it.

`nvcc` compiles every `csrc/*.cu` for `sm_90a` into a shared library with a
plain C interface (seconds, where a source that includes PyTorch's headers
takes minutes). The library lands in `build/kernels/` at the root of the
checkout (listed in .gitignore), named by a hash of the sources and flags,
so a changed source builds anew and an unchanged one is reused. Nothing
here runs at import: the first kernel launch calls `load()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the build this process ran ("" if reused)
build_seconds = 0.0


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "passion_tpu_torch build from source with nvcc")
    return found


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libpassion_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and cached in the process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int, ctypes.c_float)
            lib.pt_inl_stats.argtypes = [i32, p, i64, i64, i64, i32, f32, p,
                                         p, p]
            lib.pt_inl_stats.restype = i32
            lib.pt_inl_apply.argtypes = [i32, p, p, p, i64, i64, i64, i32,
                                         f32, p]
            lib.pt_inl_apply.restype = i32
            _lib = lib
        return _lib
