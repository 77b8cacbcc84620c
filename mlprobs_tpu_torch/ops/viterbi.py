"""3-state local-model Viterbi alignment as batched row scans (plain
PyTorch).

Reference: ProbabilisticModel.h ComputeViterbiAlignment (:1043+), the
all-pairs engine behind the `-G` feature pass and ModelAdjustmentTest
(MSA.cpp:646-882).  Uses the local transition matrix, raw match/insert
emissions, and a fixed initial distribution; ties prefer the earlier state
(M > X > Y).  The PyTorch twin of the JAX package's `ops/viterbi.py`;
the feature pass runs the wavefront form of the same DP
(ops/wavefront.viterbi_wavefront), and the traceback is a short host loop
(align/traceback.viterbi_traceback).
"""
from __future__ import annotations

import numpy as np
import torch

from mlprobs_tpu_torch.ops.semiring import (
    LOG_ZERO,
    affine_scan_max,
    shift_right,
)

# fixed Viterbi initial distribution (ProbabilisticModel.h:1075-1077)
VIT_INIT = np.log(np.array([0.6080327034, 0.1959836632, 0.1959836632],
                           dtype=np.float64)).astype(np.float32)


def _at(rows, idx):
    """rows[b, idx[b]] of a (B, L) tensor."""
    return rows.gather(1, idx.long()[:, None])[:, 0]


def viterbi_local(x, y, lx, ly, p):
    """Run the Viterbi DP on a batch of padded pairs.

    Returns (dirs, end_state, score):
      dirs: (B, Lx+1, Ly+1) int8, bit-packed per cell:
            bits 0-1 = M-state predecessor (0/1/2),
            bit 2    = X-state predecessor is X (else M),
            bit 3    = Y-state predecessor is Y (else M).
      end_state: (B,) int32 best final state at (lx, ly).
      score: (B,) float32 best final log score.
    """
    x, y = x.long(), y.long()
    B, Lx = x.shape
    Ly = y.shape[1]
    dev = x.device
    lt = p["trans"]
    lm = p["lmatch"][x[:, :, None], y[:, None, :]]           # (B, Lx, Ly)
    lm = torch.cat([torch.full_like(lm[:, :, :1], LOG_ZERO), lm], dim=2)
    lix = p["lins"][x]                                       # (B, Lx)
    iny = p["lins"][y]
    liy = torch.cat([torch.full_like(iny[:, :1], LOG_ZERO), iny],
                    dim=1)                                   # (B, Ly+1)
    jidx = torch.arange(Ly + 1, device=dev)
    zero_row = torch.full((B, Ly + 1), LOG_ZERO, dtype=lt.dtype, device=dev)
    vinit = torch.as_tensor(VIT_INIT, dtype=lt.dtype, device=dev)

    # row 0: (0,0) holds the initial distribution; Y-chain extends right
    m0 = torch.where(jidx == 0, vinit[0], zero_row)
    x0 = torch.where(jidx == 0, vinit[1], zero_row)
    c = liy + lt[0, 2] + shift_right(m0, LOG_ZERO)
    d = liy + lt[2, 2]
    y0 = torch.cat([vinit[2].expand(B, 1),
                    affine_scan_max(c[:, 1:], d[:, 1:], init=vinit[2])],
                   dim=1)
    tb_y0 = (shift_right(m0) + lt[0, 2]
             < shift_right(y0) + lt[2, 2]).to(torch.int32)
    dir_rows = [(8 * tb_y0).to(torch.int8)]
    ends = [torch.stack([_at(m0, ly), _at(x0, ly), _at(y0, ly)], dim=1)]

    pM, pX, pY = m0, x0, y0
    for i in range(1, Lx + 1):
        # M: diagonal predecessors, first-wins tie-break M > X > Y
        cm = shift_right(pM) + lt[0, 0]
        cx = shift_right(pX) + lt[1, 0]
        cy = shift_right(pY) + lt[2, 0]
        best = torch.maximum(torch.maximum(cm, cx), cy)
        M = lm[:, i - 1] + best
        M = torch.where(jidx >= 1, M, LOG_ZERO)
        tb_m = torch.where((cm >= cx) & (cm >= cy), 0,
                           torch.where(cx >= cy, 1, 2))
        # X: vertical, prefer M on ties
        from_m = pM + lt[0, 1]
        from_x = pX + lt[1, 1]
        X = lix[:, i - 1, None] + torch.maximum(from_m, from_x)
        tb_x = (from_m < from_x).to(torch.int64)
        # Y: horizontal within-row recurrence
        Mshift = shift_right(M)
        cyr = liy + lt[0, 2] + Mshift
        dyr = liy + lt[2, 2]
        Y = torch.cat([zero_row[:, :1],
                       affine_scan_max(cyr[:, 1:], dyr[:, 1:])], dim=1)
        Yshift = shift_right(Y)
        tb_y = (Mshift + lt[0, 2] < Yshift + lt[2, 2]).to(torch.int64)
        dir_rows.append((tb_m + 4 * tb_x + 8 * tb_y).to(torch.int8))
        ends.append(torch.stack([_at(M, ly), _at(X, ly), _at(Y, ly)],
                                dim=1))
        pM, pX, pY = M, X, Y
    b = torch.arange(B, device=dev)
    final = torch.stack(ends, dim=1)[b, lx.long()] + vinit   # (B, 3)
    # first-wins argmax with strict improvement (M preferred)
    end_state = torch.where(
        (final[:, 0] >= final[:, 1]) & (final[:, 0] >= final[:, 2]), 0,
        torch.where(final[:, 1] >= final[:, 2], 1, 2))
    score = final.gather(1, end_state[:, None])[:, 0]
    return (torch.stack(dir_rows, dim=1), end_state.to(torch.int32), score)
