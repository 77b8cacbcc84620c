"""ctypes bindings to the port's host helpers (csrc/host.cpp).

The progressive merge's host arithmetic: the dense MWT fill, its
traceback and the weighted profile-posterior scatter.  The library builds
with g++ at first use into `mlprobs_tpu_torch/_build/host` (listed in
.gitignore); a missing toolchain raises instead of falling back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "_build" / "host"
_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
          "-std=c++17"]

_i8p = ctypes.POINTER(ctypes.c_int8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    out = _BUILD / f"libhost_{h.hexdigest()[:12]}.so"
    if not out.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True)
        os.replace(tmp, out)
    L = ctypes.CDLL(str(out))
    L.mwt_fill_dense.restype = ctypes.c_float
    L.mwt_fill_dense.argtypes = [_f32p, ctypes.c_int, ctypes.c_int, _i8p]
    L.mwt_traceback.restype = ctypes.c_int
    L.mwt_traceback.argtypes = [_i8p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, _i8p]
    L.profile_posterior.restype = None
    L.profile_posterior.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _i64p, _i64p, _i32p, _i32p, _f32p, _i32p, _i32p, _f32p,
        _i32p, _i64p, _i32p, _i64p, ctypes.c_float, _f32p,
    ]
    return L


def _p(a: np.ndarray, ptr):
    return a.ctypes.data_as(ptr)


def mwt_fill(post: np.ndarray) -> tuple[np.ndarray, float]:
    """MWT DP fill over a 0-based (lx, ly) posterior plane.

    Returns (dirs (lx+1, ly+1) int8, score)."""
    post = np.ascontiguousarray(post, np.float32)
    lx, ly = post.shape
    dirs = np.empty((lx + 1, ly + 1), np.int8)
    score = lib().mwt_fill_dense(_p(post, _f32p), lx, ly, _p(dirs, _i8p))
    return dirs, float(score)


def mwt_traceback(dirs: np.ndarray, lx: int, ly: int) -> np.ndarray:
    """Path codes (0 = both, 1 = x only, 2 = y only) in forward order."""
    dirs = np.ascontiguousarray(dirs, dtype=np.int8)
    out = np.empty(lx + ly + 2, dtype=np.int8)
    n = lib().mwt_traceback(_p(dirs, _i8p), dirs.shape[1], lx, ly,
                            _p(out, _i8p))
    return out[:n]


def profile_posterior(l1, l2, pair_start, pair_len, a_idx, b_idx, wts,
                      coo_r, coo_c, coo_v, maps1, map1_off, maps2,
                      map2_off, cutoff_sub: float) -> np.ndarray:
    """Weighted BuildPosterior scatter (ProbabilisticModel.h:1197-1379)
    into a dense (l1, l2) float32 plane."""
    out = np.zeros((l1, l2), dtype=np.float32)
    lib().profile_posterior(
        l1, l2, len(pair_start),
        _p(pair_start, _i64p), _p(pair_len, _i64p),
        _p(a_idx, _i32p), _p(b_idx, _i32p), _p(wts, _f32p),
        _p(coo_r, _i32p), _p(coo_c, _i32p), _p(coo_v, _f32p),
        _p(maps1, _i32p), _p(map1_off, _i64p),
        _p(maps2, _i32p), _p(map2_off, _i64p),
        ctypes.c_float(cutoff_sub), _p(out, _f32p),
    )
    return out
