# Frozen copy of mlprobs_tpu_torch/ops/partition.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Probalign partition-function posterior as batched log-space row scans
(plain PyTorch).

Reference: MSAPartProbs.cpp partf (:400-660) / revers_partf (:78-396) /
ComputePostProbs (:665-727).  The reference computes in probability space
with `long double`; this formulation works in log space, in the dtype
of the tables `p` (the JAX package's in float32), the same trick the
reference's own GPU port uses (QuickProbs Kernels/PartitionLogarithm.cl).
The PyTorch twin of the JAX package's `ops/partition.py`.

Model: match state Zm with emission exp(beta*score(a,b)); affine gap
states Ze (consumes y) / Zf (consumes x) with open exp(beta*-22) and
extend exp(beta*-1); terminal gaps are free.  The posterior of a match at
(i, j) is  Zm_fwd(i,j) * Zm_rev(i,j) / (score(i,j) * Z).
"""
from __future__ import annotations

import torch

from msabench.msaref.ops.semiring import (
    LOG_ZERO,
    affine_scan_log,
    shift_right,
)


def _lse3(a, b, c):
    return torch.logaddexp(torch.logaddexp(a, b), c)


def _at(rows, idx):
    """rows[b, idx[b]] of a (B, L) tensor."""
    return rows.gather(1, idx.long()[:, None])[:, 0]


def _partition_forward(x, y, lx, ly, p):
    """Log Zm planes (B, Lx+1, Ly+1) and log total partition functions."""
    x, y = x.long(), y.long()
    B, Lx = x.shape
    Ly = y.shape[1]
    dev = x.device
    lsc = p["lscore"][x[:, :, None], y[:, None, :]]          # (B, Lx, Ly)
    lsc = torch.cat([torch.full_like(lsc[:, :, :1], LOG_ZERO), lsc], dim=2)
    lgo, lge = p["lgap_open"], p["lgap_ext"]
    jidx = torch.arange(Ly + 1, device=dev)[None, :]
    zero_row = torch.full((B, Ly + 1), LOG_ZERO, dtype=lsc.dtype, device=dev)

    # gap-in-x (Ze) costs: free when x is exhausted (terminal gap)
    # gap-in-y (Zf) costs: free before y starts (j==0) or after it ends
    free_f = (jidx == 0) | (jidx == ly[:, None])
    go_f = torch.where(free_f, 0.0, lgo)
    ge_f = torch.where(free_f, 0.0, lge)

    # row 0: zm(0,0)=1, ze(0,j>=1)=1 (free leading gap in x), zf=0
    zm0 = torch.where(jidx == 0, 0.0, zero_row)
    ze0 = torch.where(jidx >= 1, 0.0, zero_row)
    zf0 = zero_row

    pzm, pze, pzf = zm0, ze0, zf0
    zm_rows = [zm0]
    totals = [_lse3(_at(zm0, ly), _at(ze0, ly), _at(zf0, ly))]
    for i in range(1, Lx + 1):
        at_end = (i == lx)[:, None]
        # Zf: consumes x; element-wise from the previous row
        zf = torch.logaddexp(pzm + go_f, pzf + ge_f)
        zf[:, 0] = 0.0  # free leading gap in y (Zf[i][0] = 1)
        # Zm: from any state at (i-1, j-1)
        zm = lsc[:, i - 1] + shift_right(_lse3(pzm, pze, pzf))
        # Ze: consumes y; within-row recurrence, free when x exhausted
        go_e = torch.where(at_end, 0.0, lgo)
        ge_e = torch.where(at_end, 0.0, lge)
        c = shift_right(zm) + go_e
        d = ge_e.expand_as(c)
        ze = torch.cat([zero_row[:, :1], affine_scan_log(c[:, 1:],
                                                         d[:, 1:])], dim=1)
        totals.append(_lse3(_at(zm, ly), _at(ze, ly), _at(zf, ly)))
        zm_rows.append(zm)
        pzm, pze, pzf = zm, ze, zf
    lzm = torch.stack(zm_rows, dim=1)
    return lzm, _at(torch.stack(totals, dim=1), lx)


def _reverse_seq(s, length):
    """Reverse the valid prefix of each padded row, padding after it."""
    L = s.shape[1]
    k = torch.arange(L, device=s.device)[None, :]
    return s.flip(1).gather(1, (k + L - length.long()[:, None]) % L)


def partition_posterior(x, y, lx, ly, p):
    """Match posterior planes, 0-based (B, Lx, Ly); zero outside (lx, ly)."""
    x, y = x.long(), y.long()
    B, Lx = x.shape
    Ly = y.shape[1]
    dev = x.device
    lzm_f, ltotal = _partition_forward(x, y, lx, ly, p)
    xr = _reverse_seq(x, lx)
    yr = _reverse_seq(y, ly)
    lzm_rrev, _ = _partition_forward(xr, yr, lx, ly, p)
    # align: rev plane cell (lx-i+1, ly-j+1) -> (i, j)
    flipped = lzm_rrev.flip(1, 2)
    ri = (torch.arange(Lx + 1, device=dev)[None, :]
          - (lx.long() + 1 - Lx)[:, None]) % (Lx + 1)
    cj = (torch.arange(Ly + 1, device=dev)[None, :]
          - (ly.long() + 1 - Ly)[:, None]) % (Ly + 1)
    b = torch.arange(B, device=dev)[:, None, None]
    lzm_r = flipped[b, ri[:, :, None], cj[:, None, :]]
    lsc = p["lscore"][x[:, :, None], y[:, None, :]]          # (B, Lx, Ly)
    lpost = lzm_f[:, 1:, 1:] + lzm_r[:, 1:, 1:] - lsc \
        - ltotal[:, None, None]
    post = torch.exp(torch.clamp(lpost, max=0.0))
    ivalid = torch.arange(Lx, device=dev)[None, :, None] < lx[:, None, None]
    jvalid = torch.arange(Ly, device=dev)[None, None, :] < ly[:, None, None]
    return torch.where(ivalid & jvalid, post, 0.0)
