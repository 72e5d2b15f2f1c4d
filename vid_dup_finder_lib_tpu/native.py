"""ctypes bindings for the native host runtime (native_src/vdf_native.cpp).

Builds the shared library on first use (g++, cached next to the source,
rebuilt when the source changes) and degrades gracefully to the NumPy paths
when no compiler is available.  The C++ source ships as package data, so
installed wheels build it the same way a source checkout does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "native_src",
    "vdf_native.cpp",
)
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _build_lib() -> str | None:
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    cache_dir = os.environ.get("VDF_NATIVE_CACHE", os.path.dirname(_SRC))
    os.makedirs(cache_dir, exist_ok=True)
    out = os.path.join(cache_dir, f"libvdf_native_{digest}.so")
    if os.path.exists(out):
        return out
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC",
        "-o", out + ".tmp", _SRC, "-lpthread",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(out + ".tmp", out)
        return out
    except Exception:
        return None


def get_lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = _build_lib()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.vdf_banded_adjacency.restype = ctypes.c_int64
        lib.vdf_banded_adjacency.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ]
        lib.vdf_distances_one.restype = None
        lib.vdf_distances_one.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.vdf_count_leq.restype = ctypes.c_int64
        lib.vdf_count_leq.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_uint32, ctypes.c_int,
        ]
        lib.vdf_refs_windowed.restype = ctypes.c_int64
        lib.vdf_refs_windowed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int,
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return get_lib() is not None


def banded_adjacency_native(
    packed_u64: np.ndarray,
    bounds: np.ndarray,
    tolerance_int: int,
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Native banded sweep.  packed_u64: uint64[N, 16] (the reference's
    word layout).  Returns (i, j) pairs in lexicographic order."""
    lib = get_lib()
    assert lib is not None, "native library unavailable"
    packed_u64 = np.ascontiguousarray(packed_u64, dtype=np.uint64)
    n = packed_u64.shape[0]
    assert packed_u64.shape[1] == 16
    bounds64 = np.ascontiguousarray(bounds, dtype=np.int64)

    cap = 1 << 16
    while True:
        out = np.empty((cap, 2), dtype=np.int64)
        found = lib.vdf_banded_adjacency(
            packed_u64.ctypes.data, bounds64.ctypes.data, n,
            tolerance_int, out.ctypes.data, cap, n_threads,
        )
        if found <= cap:
            break
        cap = int(found) + 1024  # retry with exact capacity
    pairs = out[: min(found, cap)]
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    pairs = pairs[order]
    return pairs[:, 0].copy(), pairs[:, 1].copy()


def refs_windowed_native(
    refs_u64: np.ndarray,
    cands_u64: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    tolerance_int: int,
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Native windowed refs-vs-candidates sweep: all pairs (i, j) with
    lo[i] <= j < min(hi[i], n) and hamming <= tolerance_int, in
    lexicographic order (the search_with_references batched path on
    CPU-only hosts)."""
    lib = get_lib()
    assert lib is not None, "native library unavailable"
    refs_u64 = np.ascontiguousarray(refs_u64, dtype=np.uint64)
    cands_u64 = np.ascontiguousarray(cands_u64, dtype=np.uint64)
    assert refs_u64.shape[1] == 16 and cands_u64.shape[1] == 16
    r, n = refs_u64.shape[0], cands_u64.shape[0]
    lo64 = np.ascontiguousarray(lo, dtype=np.int64)
    hi64 = np.ascontiguousarray(hi, dtype=np.int64)

    cap = 1 << 16
    while True:
        out = np.empty((cap, 2), dtype=np.int64)
        found = lib.vdf_refs_windowed(
            refs_u64.ctypes.data, r, cands_u64.ctypes.data, n,
            lo64.ctypes.data, hi64.ctypes.data,
            tolerance_int, out.ctypes.data, cap, n_threads,
        )
        if found <= cap:
            break
        cap = int(found) + 1024
    pairs = out[: min(found, cap)]
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    pairs = pairs[order]
    return pairs[:, 0].copy(), pairs[:, 1].copy()


def distances_one_native(
    target_u32: np.ndarray, cands_u32: np.ndarray
) -> np.ndarray:
    """dists[k] = hamming(target, cands[k]) (search_algorithm.rs:63-77).

    Inputs in the uint32[.., 32] search layout; words are viewed as the
    u64 pairs the C side consumes."""
    lib = get_lib()
    assert lib is not None, "native library unavailable"
    t64 = np.ascontiguousarray(target_u32, dtype=np.uint32).view(
        np.uint64
    )
    c64 = np.ascontiguousarray(cands_u32, dtype=np.uint32).view(
        np.uint64
    )
    n = c64.shape[0]
    out = np.empty(n, dtype=np.uint32)
    lib.vdf_distances_one(
        t64.ctypes.data, c64.ctypes.data, n, out.ctypes.data
    )
    return out.astype(np.int64)


def count_leq_native(
    packed_u64: np.ndarray,
    bounds: np.ndarray,
    tolerance_int: int,
    n_threads: int = 1,
) -> int:
    lib = get_lib()
    assert lib is not None
    packed_u64 = np.ascontiguousarray(packed_u64, dtype=np.uint64)
    bounds64 = np.ascontiguousarray(bounds, dtype=np.int64)
    return int(
        lib.vdf_count_leq(
            packed_u64.ctypes.data, bounds64.ctypes.data,
            packed_u64.shape[0], tolerance_int, n_threads,
        )
    )
