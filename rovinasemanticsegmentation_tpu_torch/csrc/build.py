"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

The kernels have a plain C interface (raw pointers, sizes and a stream), so
they compile in seconds without PyTorch's headers. Each source compiles in
its own nvcc process, all started together, and the objects are linked into
one shared library in ``csrc/_build/`` under a name keyed by a hash of the
sources and the flags; a file lock keeps parallel processes from building it
twice. A failed build raises with nvcc's stderr: nothing falls back to the
plain versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
SOURCES = (
    "patches.cu", "forest_descent.cu", "forest_descent_staged.cu",
    "patches_planar.cu",
)
# No --use_fast_math: the patch kernel's floorf(77 / (2 d)) must be IEEE
# division to stay bit-exact with the plain version.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# Dynamic shared memory one block can use on sm_90 (after opting in above
# 48 KB); the wrappers refuse a tile that needs more.
MAX_SHARED_BYTES = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# Signatures of the C entry points; every one returns cudaGetLastError().
_SIGNATURES = {
    # lab, pixels, out, stream
    "rovina_pack_lab": [_P, _I, _P, _P],
    # packed, wp, depth, gh, gw, t0, t1, w0, w1, patch, reduce, stride,
    # out, row0, row_bytes, stream
    "rovina_patches": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                       _P, _I64, _I, _P],
    # rows, P, row_bytes, pc, tail_off, records, T, N, leaf_hist, LC,
    # max_depth, feat_bits, tile_points, leaves, posterior, stream
    "rovina_forest_descent": [_P, _I64, _I, _I, _I, _P, _I, _I, _P, _I, _I,
                              _I, _I, _P, _P, _P],
    # features, P, D, hot, records, T, N, max_depth, feat_bits, tile_points,
    # leaves, stream
    "rovina_forest_descent_staged": [_P, _I64, _I, _I, _P, _I, _I, _I, _I,
                                     _I, _P, _P],
    # planar, hp, wp, depth, gh, gw, t0, t1, w0, w1, patch, reduce, stride,
    # group, out, stream
    "rovina_patches_planar": [_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I,
                              _I, _I, _I, _P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built"
        )
    return found


def _library_path(sources: List[str]) -> str:
    h = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"librovina_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds: List[List[str]]) -> None:
    """Run the commands in parallel; raise with the first failure's stderr."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for c in cmds
    ]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (_, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (rc {proc.returncode}): {' '.join(cmd)}\n{err}"
            )


def _build(so_path: str, sources: List[str]) -> None:
    nvcc = _nvcc()
    tmp = f"{so_path}.{os.getpid()}"
    objects = [f"{tmp}.{os.path.basename(s)}.o" for s in sources]
    try:
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(sources, objects)
        ])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tmp}.so", *objects]])
        os.replace(f"{tmp}.so", so_path)
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use in this checkout."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = [os.path.join(_DIR, s) for s in SOURCES]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so_path = _library_path(sources)
        with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            try:
                if not os.path.exists(so_path):
                    _build(so_path, sources)
            finally:
                fcntl.flock(lock_file, fcntl.LOCK_UN)
        lib = ctypes.CDLL(so_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rovina_error_string.argtypes = [ctypes.c_int]
        lib.rovina_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load_kernels().rovina_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


class LaunchCounter:
    """Counts kernel launches, so a run can show its path went through them."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n
