"""Build the port's CUDA sources into one shared library and load it.

`nvcc` compiles every `csrc/*.cu` for `sm_90a` into an object file, all
sources at once in parallel processes, and links them into one shared
library with a plain C interface (seconds, where a source that includes
PyTorch's headers takes minutes). The library lands in `build/kernels/` at
the root of the checkout (listed in .gitignore), named by a hash of the
sources and flags, so a changed source builds anew and an unchanged one is
reused. Nothing here runs at import: the first kernel launch calls
`load()`.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> str:
    """Wait for every process; raise with all output if any failed."""
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} -> {proc.returncode}")
    log = "".join(logs)
    if failed:
        raise RuntimeError("nvcc failed: " + "; ".join(failed) + "\n" + log)
    return log


def _start(cmd: list[str]) -> tuple[list[str], subprocess.Popen]:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = []
    try:
        compiles = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            objs.append(obj)
            compiles.append(_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                    str(src)]))
        log = _run(compiles)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log += _run([_start([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                             *map(str, objs)])])
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        for p in objs + [out.with_name(f"{out.name}.{os.getpid()}.tmp")]:
            p.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = log
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and cached in the process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i64, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_uint,
                                     ctypes.c_float)
            signatures = {
                # dtype, x, rows, n, chunk, vectorized, eps, part, stats,
                # stream
                "pt_inl_stats": [i32, p, i64, i64, i64, i32, f32, p, p, p],
                # dtype, x, stats, y, rows, n, chunk, vectorized, slope,
                # stream
                "pt_inl_apply": [i32, p, p, p, i64, i64, i64, i32, f32, p],
                # dtype, x, g, stats, rows, n, chunk, vectorized, slope,
                # part, bstats, stream
                "pt_inl_bwd_stats": [i32, p, p, p, i64, i64, i64, i32, f32,
                                     p, p, p],
                # dtype, x, g, stats, bstats, dx, rows, n, chunk,
                # vectorized, slope, stream
                "pt_inl_bwd_apply": [i32, p, p, p, p, p, i64, i64, i64, i32,
                                     f32, p],
                # labels, n, h, w, z, class bits, a_threads, a_shared,
                # b_shared, out, stream
                "pt_edt_sq": [p, i64, i64, i64, i64, u32, i32, i64, i64, p,
                              p],
                # dtype, x, y, planes, d, h, w, pad, stream
                "pt_reflect_pad3d": [i32, p, p, i64, i64, i64, i64, i64, p],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = i32
            _lib = lib
        return _lib
