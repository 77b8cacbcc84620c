"""Maximum-weight-trace alignment DP (maximum expected accuracy) over
batched dense posterior planes (plain PyTorch).

Reference: ProbabilisticModel.h ComputeAlignment (:804-864).  Gap moves
cost nothing, so the within-row recurrence

    S(i,j) = max(p(i,j) + S(i-1,j-1), S(i,j-1), S(i-1,j))

collapses to a running maximum: with a_j = max(p + S_up_diag, S_up),
S(i,:) is simply cummax(a).  Tie-breaking reproduces ChooseBestOfThree
(ScoreType.h:347-366): diagonal >= left >= up.  The PyTorch twin of the
JAX package's `ops/mwt.py`; the row-scan (`scan`) posterior engine runs
it, and the tracebacks of the merge are host code
(align/traceback.mwt_traceback).
"""
from __future__ import annotations

import torch


def mwt_align(post, lx, ly):
    """Fill the MWT DP over 0-based posterior planes.

    post: (B, Lx, Ly) float32 (post[b, i-1, j-1] = p(i, j)); lx, ly (B,).
    Returns (dirs (B, Lx+1, Ly+1) int8 with 0=diag, 1=left, 2=up;
    score (B,) float32 at (lx, ly)).
    """
    B, Lx, Ly = post.shape
    zcol = torch.zeros((B, 1), dtype=post.dtype, device=post.device)
    s_prev = torch.zeros((B, Ly + 1), dtype=post.dtype, device=post.device)
    dir_rows = [torch.ones((B, Ly + 1), dtype=torch.int8,
                           device=post.device)]           # row 0: left
    scores = [s_prev[:, 0]]
    for i in range(1, Lx + 1):
        p = torch.cat([zcol, post[:, i - 1]], dim=1)
        pd = p + torch.cat([zcol, s_prev[:, :-1]], dim=1)  # diagonal
        up = s_prev                                          # up
        s = torch.cummax(torch.maximum(pd, up), dim=1).values
        s[:, 0] = 0.0
        left = torch.cat([zcol, s[:, :-1]], dim=1)          # new[j-1]
        dirs = torch.where((pd >= left) & (pd >= up), 0,
                           torch.where(left >= up, 1, 2)).to(torch.int8)
        dirs[:, 0] = 2                                       # column 0: up
        dir_rows.append(dirs)
        scores.append(s.gather(1, ly.long()[:, None])[:, 0])
        s_prev = s
    score = torch.stack(scores, dim=1).gather(1, lx.long()[:, None])[:, 0]
    return torch.stack(dir_rows, dim=1), score


def count_matches(dirs, lx, ly):
    """Number of diagonal ('B') moves on each traceback from (lx, ly).

    All tracebacks of the batch step together, as many steps as the
    longest path (lx + ly at most), so that the direction planes never
    leave the device; the non-progressive path's distance is
    score / #matches (MSA.cpp:1745-1752).
    """
    r, c = lx.long().clone(), ly.long().clone()
    b = torch.arange(dirs.shape[0], device=dirs.device)
    nb = torch.zeros_like(r)
    for _ in range(int((r + c).max()) if r.numel() else 0):
        live = (r > 0) | (c > 0)
        d = dirs[b, r, c]
        r = torch.where(live & (d != 1), r - 1, r)
        c = torch.where(live & (d != 2), c - 1, c)
        nb += (live & (d == 0)).long()
    return nb.to(torch.int32)
