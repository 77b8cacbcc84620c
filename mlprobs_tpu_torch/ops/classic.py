"""Classic affine-gap pairwise aligners: Smith-Waterman local and
Needleman-Wunsch global.

Reference: realign/QuickProbs/src/Alignment/Pairwise/SmithWaterman.cpp,
NeedlemanWunsch.cpp, Backtrack.cpp — support aligners outside the main
probabilistic path (IPairwiseAligner.h), provided for API completeness.
Affine gap model matches the reference: a gap of length g costs
gi + (g-1) * ge (gi = gap init including the first residue).

Row-vectorised numpy: the in-row E/H coupling is unrolled with the
ramp-subtracted running-max trick (E[x] = max_{k<x} H[k]+gi+(x-1-k)*ge),
so each row is O(L) numpy ops — the same formulation as the host MWT
fill (align/progressive._mwt_host).  Host code, as in the JAX package,
whose `ops/classic.py` this module copies.
"""
from __future__ import annotations

import numpy as np

NEG = -(2 ** 30)


def _row_update(h_prev, f_prev, subs_row, gi, ge, local: bool):
    """One DP row.  Returns (h, e, f) for the current row."""
    w = h_prev.shape[0]
    f = np.maximum(f_prev + ge, h_prev + gi)
    f[0] = 0 if local else f_prev[0]
    diag = np.full(w, NEG, dtype=np.int64)
    diag[1:] = h_prev[:-1] + subs_row
    a = np.maximum(diag, f)
    if local:
        a = np.maximum(a, 0)
    # E[x] = max(E[x-1]+ge, H[x-1]+gi) with H[x-1] = max(A[x-1], E[x-1])
    # and ge >= gi  =>  E[x] = max_{k<x} A[k] + gi + (x-1-k)*ge:
    # subtract the ge ramp and running-max
    idx = np.arange(w, dtype=np.int64)
    base = np.full(w, NEG, dtype=np.float64)
    base[1:] = a[:-1] + gi - idx[1:] * ge
    e = (np.maximum.accumulate(base) + idx * ge)
    e = np.where(e < NEG // 2, NEG, e).astype(np.int64)
    h = np.maximum(a, e)
    return h, e, f


def smith_waterman(x, y, subs, gi: int, ge: int):
    """Local alignment score + end cell.  x/y: int arrays (class codes);
    subs: (C, C) int matrix; returns (score, end_i, end_j)."""
    x = np.asarray(x)
    y = np.asarray(y)
    lx, ly = len(x), len(y)
    h = np.zeros(ly + 1, dtype=np.int64)
    f = np.zeros(ly + 1, dtype=np.int64)
    best, bi, bj = NEG, 0, 0
    for i in range(1, lx + 1):
        srow = subs[x[i - 1]][y]
        h, e, f = _row_update(h, f, srow, gi, ge, local=True)
        h[0] = 0
        j = int(np.argmax(h))
        if h[j] > best:
            best, bi, bj = int(h[j]), i, j
    return best, bi, bj


def needleman_wunsch(x, y, subs, gi: int, ge: int):
    """Global alignment score (terminal gaps charged, reference init
    H[x] = gi + (x-1)*ge)."""
    x = np.asarray(x)
    y = np.asarray(y)
    lx, ly = len(x), len(y)
    idx = np.arange(ly + 1, dtype=np.int64)
    h = np.where(idx == 0, 0, gi + (idx - 1) * ge)
    f = h.copy()
    for i in range(1, lx + 1):
        srow = subs[x[i - 1]][y]
        col0 = gi + (i - 1) * ge
        f = np.maximum(f + ge, h + gi)
        diag = np.full(ly + 1, NEG, dtype=np.int64)
        diag[1:] = h[:-1] + srow
        a = np.maximum(diag, f)
        a[0] = col0
        jdx = np.arange(ly + 1, dtype=np.int64)
        base = np.full(ly + 1, NEG, dtype=np.float64)
        base[1:] = a[:-1] + gi - jdx[1:] * ge
        e = np.maximum.accumulate(base) + jdx * ge
        e = np.where(e < NEG // 2, NEG, e).astype(np.int64)
        h = np.maximum(a, e)
        h[0] = col0
    return int(h[ly])


def sw_align(x, y, subs, gi: int, ge: int):
    """Full local alignment with backtrack.  Returns (score, path)
    where path is a list of (i, j) 1-based matched/substituted cells
    plus gap moves encoded as (i, 0) / (0, j)."""
    x = np.asarray(x)
    y = np.asarray(y)
    lx, ly = len(x), len(y)
    H = np.zeros((lx + 1, ly + 1), dtype=np.int64)
    E = np.zeros_like(H)
    F = np.zeros_like(H)
    for i in range(1, lx + 1):
        srow = subs[x[i - 1]][y]
        for j in range(1, ly + 1):
            E[i, j] = max(E[i, j - 1] + ge, H[i, j - 1] + gi)
            F[i, j] = max(F[i - 1, j] + ge, H[i - 1, j] + gi)
            H[i, j] = max(0, E[i, j], F[i, j],
                          H[i - 1, j - 1] + srow[j - 1])
    i, j = np.unravel_index(np.argmax(H), H.shape)
    score = int(H[i, j])
    path = []
    while i > 0 and j > 0 and H[i, j] > 0:
        if H[i, j] == H[i - 1, j - 1] + subs[x[i - 1]][y[j - 1]]:
            path.append((int(i), int(j)))
            i, j = i - 1, j - 1
        elif H[i, j] == E[i, j]:
            path.append((0, int(j)))
            j -= 1
        else:
            path.append((int(i), 0))
            i -= 1
    path.reverse()
    return score, path
