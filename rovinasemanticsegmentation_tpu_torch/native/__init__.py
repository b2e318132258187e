"""Native (C++) host components: the lattice builder and the forest.dat decoder.

The port's copy of ``rovinasemanticsegmentation_tpu/native`` (it imports
nothing of that package). The library builds on first use with g++ from this
folder's own sources (``lattice_builder.cpp``, ``forest_codec.cpp``) into
``csrc/_build/``, under a name keyed by a hash of the sources and flags, and is
loaded through ctypes. Every entry point returns None when the library cannot
be built, and its caller falls back to NumPy, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "csrc", "_build")
_SOURCES = ["lattice_builder.cpp", "forest_codec.cpp"]
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _library_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in _SOURCES:
        with open(os.path.join(_DIR, s), "rb") as f:
            h.update(s.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"librovina_native_{h.hexdigest()[:16]}.so")


def _build(so_path: str) -> bool:
    tmp = f"{so_path}.{os.getpid()}"
    cmd = ["g++", *_FLAGS, "-o", tmp] + [os.path.join(_DIR, s) for s in _SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so_path)
        return True
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        log.warning("native build failed, using Python fallbacks: %s", e)
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        os.makedirs(BUILD_DIR, exist_ok=True)
        so_path = _library_path()
        with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            try:
                if not os.path.exists(so_path) and not _build(so_path):
                    return None
            finally:
                fcntl.flock(lock_file, fcntl.LOCK_UN)
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            log.warning("native load failed: %s", e)
            return None
        lib.rovina_lattice_build.restype = ctypes.c_int
        lib.rovina_lattice_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        lib.rovina_lattice_neighbors.restype = ctypes.c_int
        lib.rovina_lattice_neighbors.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        lib.rovina_forest_decode.restype = ctypes.c_int
        lib.rovina_forest_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.rovina_forest_sizes.argtypes = [
            ctypes.POINTER(ctypes.c_int64)] * 3
        lib.rovina_forest_fetch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_lattice_build(
    features: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]]:
    """(offsets, barycentric, blur_n1, blur_n2, M) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    f = np.ascontiguousarray(features, dtype=np.float32)
    n, d = f.shape
    offsets = np.empty((n, d + 1), np.int32)
    bary = np.empty((n, d + 1), np.float32)
    m = lib.rovina_lattice_build(
        _ptr(f, ctypes.c_float), n, d,
        _ptr(offsets, ctypes.c_int32), _ptr(bary, ctypes.c_float),
    )
    if m < 0:
        return None
    blur_n1 = np.empty((d + 1, m), np.int32)
    blur_n2 = np.empty((d + 1, m), np.int32)
    m2 = lib.rovina_lattice_neighbors(
        _ptr(blur_n1, ctypes.c_int32), _ptr(blur_n2, ctypes.c_int32), m
    )
    if m2 != m:
        return None
    return offsets, bary, blur_n1, blur_n2, m


def native_forest_decode(data: bytes):
    """Decode forest.dat bytes -> raw flat arrays, or None if unavailable.

    Returns (node_counts [T], split [sumN], thresholds [sumN], left [sumN],
    hist_index [R, 5], hist_values [V]).
    """
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    tree_count = lib.rovina_forest_decode(_ptr(buf, ctypes.c_uint8), len(buf))
    if tree_count < 0:
        return None
    total_nodes = ctypes.c_int64()
    hist_rows = ctypes.c_int64()
    hist_values = ctypes.c_int64()
    lib.rovina_forest_sizes(
        ctypes.byref(total_nodes), ctypes.byref(hist_rows),
        ctypes.byref(hist_values),
    )
    node_counts = np.empty(tree_count, np.int32)
    split = np.empty(total_nodes.value, np.int32)
    thr = np.empty(total_nodes.value, np.float32)
    left = np.empty(total_nodes.value, np.int32)
    hist_index = np.empty((hist_rows.value, 5), np.int32)
    hist_vals = np.empty(hist_values.value, np.float32)
    lib.rovina_forest_fetch(
        _ptr(node_counts, ctypes.c_int32), _ptr(split, ctypes.c_int32),
        _ptr(thr, ctypes.c_float), _ptr(left, ctypes.c_int32),
        _ptr(hist_index, ctypes.c_int32), _ptr(hist_vals, ctypes.c_float),
    )
    return node_counts, split, thr, left, hist_index, hist_vals
