"""The progressive merge's host arithmetic in NumPy: the dense MWT fill,
its traceback and the weighted profile-posterior scatter.

Plain versions of the port's C++ helpers (mlprobs_tpu_torch/csrc/
host.cpp at commit 30598a0, bound by utils/host.py), under the same
names and arguments.  The fill and the scatter are frozen copies of the
JAX package's NumPy path (mlprobs_tpu/align/progressive.py `_mwt_host`
and `build_profile_posterior`, the same commit), which the C++ equals
bit for bit; the traceback is its Python loop
(mlprobs_tpu/align/traceback.py)."""
from __future__ import annotations

import numpy as np

# the control of the correctness check: each profile-posterior plane
# rounded to bfloat16 before the MWT (False: float32, as the port)
PLANE_BF16 = False


def round_bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    as float32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    u = (u + (((u >> 16) & 1) + 0x7FFF)) & np.uint32(0xFFFF0000)
    return u.astype(np.uint32).view(np.float32)


def mwt_fill(post: np.ndarray) -> tuple[np.ndarray, float]:
    """MWT DP fill over a 0-based (lx, ly) posterior plane, a row at a
    time along the shorter side; tie order diagonal >= left >= up.
    (dirs (lx+1, ly+1) int8, score)."""
    post = np.asarray(post, dtype=np.float32)
    lx, ly = post.shape
    if lx <= ly:
        return _fill_rows(post, left_code=1, up_code=2)
    # the same recurrence over the transposed plane: its "left" is the
    # plane's up and its "up" the plane's left, so left wins ties as
    # the plane's up would, and the codes swap
    dirs_t, score = _fill_rows(np.ascontiguousarray(post.T), left_code=2,
                               up_code=1, left_first=False)
    return np.ascontiguousarray(dirs_t.T), score


def _fill_rows(post, left_code, up_code, left_first=True):
    """The fill a row at a time: S[i, j] = max(post[i-1, j-1] +
    S[i-1, j-1], S[i, j-1], S[i-1, j]), the diagonal first among equals,
    then left before up (`left_first`) or up before left."""
    lx, ly = post.shape
    dirs = np.empty((lx + 1, ly + 1), dtype=np.int8)
    dirs[0, :] = left_code
    dirs[0, 0] = 1
    s_prev = np.zeros(ly + 1, dtype=np.float32)
    for i in range(1, lx + 1):
        pd = np.empty(ly + 1, dtype=np.float32)
        pd[0] = 0.0
        pd[1:] = post[i - 1] + s_prev[:-1]
        s = np.maximum.accumulate(np.maximum(pd, s_prev))
        s[0] = 0.0
        left = np.empty_like(s)
        left[0] = 0.0
        left[1:] = s[:-1]
        side = (left >= s_prev) if left_first else (s_prev < left)
        d = np.where((pd >= left) & (pd >= s_prev), 0,
                     np.where(side, left_code, up_code)).astype(np.int8)
        d[0] = up_code
        dirs[i] = d
        s_prev = s
    return dirs, float(s_prev[ly])


def mwt_traceback(dirs: np.ndarray, lx: int, ly: int) -> np.ndarray:
    """Path codes (0 = both, 1 = x only, 2 = y only) in forward order."""
    out = []
    r, c = lx, ly
    while r != 0 or c != 0:
        d = dirs[r, c]
        if d == 0:
            r -= 1
            c -= 1
            out.append(0)
        elif d == 1:
            c -= 1
            out.append(2)
        else:
            r -= 1
            out.append(1)
    return np.array(out[::-1], dtype=np.int8)


def profile_posterior(l1, l2, pair_start, pair_len, a_idx, b_idx, wts,
                      coo_r, coo_c, coo_v, maps1, map1_off, maps2,
                      map2_off, cutoff_sub: float) -> np.ndarray:
    """Weighted BuildPosterior scatter into a dense (l1, l2) f32 plane:
    each entry adds the f32 product (float)w * v, a cell sums its
    entries in f64 in pair order, the subtractions w * cutoff sum in f64
    into a second plane added after, each cell cast to f32 once."""
    flat_idx, flat_val = [], []
    sub = None
    for p in range(len(pair_start)):
        s0, n = int(pair_start[p]), int(pair_len[p])
        a, b = int(a_idx[p]), int(b_idx[p])
        m1 = maps1[map1_off[a]:map1_off[a + 1]].astype(np.int64)
        m2 = maps2[map2_off[b]:map2_off[b + 1]].astype(np.int64)
        r = coo_r[s0:s0 + n]
        c = coo_c[s0:s0 + n]
        flat_idx.append(m1[r] * l2 + m2[c])
        flat_val.append((np.float32(wts[p]) * coo_v[s0:s0 + n])
                        .astype(np.float64))
        if cutoff_sub:
            if sub is None:
                sub = np.zeros((l1, l2), dtype=np.float64)
            sub[np.ix_(m1, m2[:-1])] -= float(wts[p]) * cutoff_sub
    out = np.bincount(
        np.concatenate(flat_idx) if flat_idx else np.zeros(0, np.int64),
        weights=np.concatenate(flat_val) if flat_val else None,
        minlength=l1 * l2,
    ).reshape(l1, l2)
    if sub is not None:
        out = out + sub
    out = out.astype(np.float32)
    return round_bf16(out) if PLANE_BF16 else out
