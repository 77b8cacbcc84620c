"""EM parameter re-estimation for the 5-state pair HMM (plain PyTorch).

Reference: ProbabilisticModel::ComputeNewParameters
(baseMSA/C_P_NP_Aln/ProbabilisticModel.h:586-788).  The reference ships
this for offline parameter training; the pipeline never calls it
(MSA.cpp uses fixed Defaults.h parameters), but it is part of the
library surface.  The PyTorch twin of the JAX package's `ops/em.py`:
full-state forward and backward planes from one loop over rows each (the
JAX package's `lax.scan`), expected transition / initial-state /
emission counts as log-sum-exp reductions over the (Lx+1, Ly+1) grid,
and the reference's normalisation into new (init, gap_open, gap_extend,
emit_pairs, emit_single).  It runs in f32 on the device of `x`; within a
row, the y-consuming states resolve with the row scans of
ops/semiring.py.

State order matches models/params.hmm5_params: 0=M, 1=X1, 2=Y1, 3=X2,
4=Y2 with transition matrix p["trans"][from, to]; `p` is
`align/pairwise.hmm5_dict()`.
"""
from __future__ import annotations

import torch

from mlprobs_tpu_torch.ops.pairhmm import _lse
from mlprobs_tpu_torch.ops.semiring import (
    LOG_ZERO, affine_scan_log, shift_left, shift_right,
)


def _lse_all(t):
    """log(sum(exp(t))) over every element."""
    return torch.logsumexp(t.reshape(-1), dim=0)


def _masked(term, ok):
    if isinstance(ok, bool):
        return term if ok else torch.full_like(term, LOG_ZERO)
    return torch.where(ok, term, LOG_ZERO)


def _full_forward(x, y, p):
    """All-state forward planes: (5, Lx+1, Ly+1) log values."""
    Lx, Ly = x.shape[0], y.shape[0]
    dev = x.device
    t, init = p["trans"], p["init"]
    xl, yl = x.long(), y.long()
    match = p["lmatch"][xl[:, None], yl[None, :]]
    insx = p["lins"][xl]
    insy_row = torch.cat(
        [torch.full((1, 2), LOG_ZERO, device=dev), p["lins"][yl]], dim=0)
    jidx = torch.arange(Ly + 1, device=dev)
    zero_row = torch.full((Ly + 1,), LOG_ZERO, device=dev)

    def y0_row(k):
        c = torch.where(jidx == 1, init[2 * k + 2] + insy_row[:, k],
                        LOG_ZERO)
        d = insy_row[:, k] + t[2 * k + 2, 2 * k + 2]
        u = affine_scan_log(c[1:], d[1:])
        return torch.cat([zero_row[:1], u])

    carry = (zero_row, zero_row, y0_row(0), zero_row, y0_row(1))
    rows = [torch.stack(carry)]
    for i in range(1, Lx + 1):
        pM, pX1, pY1, pX2, pY2 = carry
        mrow = torch.cat([zero_row[:1], match[i - 1]])
        ix = insx[i - 1]
        rec = _lse(
            shift_right(pM) + t[0, 0],
            shift_right(pX1) + t[1, 0],
            shift_right(pY1) + t[2, 0],
            shift_right(pX2) + t[3, 0],
            shift_right(pY2) + t[4, 0],
        )
        inj_m = _masked(init[0].expand(Ly + 1), (jidx == 1) & (i == 1))
        M = mrow + torch.logaddexp(rec, inj_m)

        def x_state(k, pXk):
            inj = _masked(init[2 * k + 1].expand(Ly + 1),
                          (jidx == 0) & (i == 1))
            return ix[k] + _lse(
                pM + t[0, 2 * k + 1],
                pXk + t[2 * k + 1, 2 * k + 1], inj
            )

        X1, X2 = x_state(0, pX1), x_state(1, pX2)
        Mshift = shift_right(M)

        def y_state(k):
            c = insy_row[:, k] + t[0, 2 * k + 2] + Mshift
            d = insy_row[:, k] + t[2 * k + 2, 2 * k + 2]
            u = affine_scan_log(c[1:], d[1:])
            return torch.cat([zero_row[:1], u])

        carry = (M, X1, y_state(0), X2, y_state(1))
        rows.append(torch.stack(carry))
    return torch.stack(rows).transpose(0, 1)


def _full_backward(x, y, p):
    """All-state backward planes: (5, Lx+1, Ly+1) log values."""
    Lx, Ly = x.shape[0], y.shape[0]
    dev = x.device
    t, init = p["trans"], p["init"]
    pad = torch.full((1,), 20, dtype=torch.long, device=dev)
    xn = torch.cat([x.long(), pad])
    yn = torch.cat([y.long(), pad])
    match_next = p["lmatch"][xn[:, None], yn[None, :]]
    insx_next = p["lins"][xn]
    insy_next = p["lins"][yn]
    jidx = torch.arange(Ly + 1, device=dev)
    yvalid = jidx < Ly
    zero_row = torch.full((Ly + 1,), LOG_ZERO, device=dev)

    carry = (zero_row,) * 5
    rows = []
    for i in range(Lx, -1, -1):
        nM, nX1, nY1, nX2, nY2 = carry
        xvalid = i < Lx
        inj = _masked(torch.zeros_like(zero_row), (jidx == Ly) & (i == Lx))
        mterm = _masked(match_next[i] + shift_left(nM), yvalid & xvalid)

        def y_state(k):
            c = torch.logaddexp(mterm + t[2 * k + 2, 0],
                                inj + init[2 * k + 2])
            d = _masked(insy_next[:, k] + t[2 * k + 2, 2 * k + 2], yvalid)
            return affine_scan_log(c, d, reverse=True)

        Y1, Y2 = y_state(0), y_state(1)

        def x_state(k, nXk):
            return _lse(
                mterm + t[2 * k + 1, 0],
                _masked(insx_next[i, k] + nXk + t[2 * k + 1, 2 * k + 1],
                        xvalid),
                inj + init[2 * k + 1],
            )

        X1, X2 = x_state(0, nX1), x_state(1, nX2)
        M = _lse(
            mterm + t[0, 0],
            _masked(insx_next[i, 0] + nX1 + t[0, 1], xvalid),
            _masked(insx_next[i, 1] + nX2 + t[0, 3], xvalid),
            _masked(insy_next[:, 0] + shift_left(Y1) + t[0, 2], yvalid),
            _masked(insy_next[:, 1] + shift_left(Y2) + t[0, 4], yvalid),
            inj + init[0],
        )
        carry = (M, X1, Y1, X2, Y2)
        rows.append(torch.stack(carry))
    return torch.stack(rows[::-1]).transpose(0, 1)


def hmm5_em_step(x, y, p, train_emissions: bool = False):
    """One EM re-estimation from a single pair (x, y), full lengths.

    x, y: 1-D class tensors on one device; `p` the hmm5 log tables on it.
    Returns dict with "init" (5,), "gap_open" (4,), "gap_extend" (4,)
    and, when train_emissions, "emit_pairs" (21, 21) / "emit_single"
    (21,) — the same normalised quantities ComputeNewParameters writes
    into initDistribMat/gapOpen/gapExtend/emitPairs/emitSingle."""
    Lx, Ly = x.shape[0], y.shape[0]
    t, init = p["trans"], p["init"]
    f = _full_forward(x, y, p)     # (5, Lx+1, Ly+1)
    b = _full_backward(x, y, p)
    total = _lse_all(f[:, Lx, Ly] + init)

    xl, yl = x.long(), y.long()
    match = p["lmatch"][xl[:, None], yl[None, :]]      # (Lx, Ly)
    insx = p["lins"][xl]                               # (Lx, 2)
    insy = p["lins"][yl]                               # (Ly, 2)

    # init counts: f+b at the entry cells plus the terminal cell
    # (ProbabilisticModel.h:621-635)
    fb = f + b
    init_counts = torch.stack([
        torch.logaddexp(fb[0, 1, 1], fb[0, Lx, Ly]),
        torch.logaddexp(fb[1, 1, 0], fb[1, Lx, Ly]),
        torch.logaddexp(fb[2, 0, 1], fb[2, Lx, Ly]),
        torch.logaddexp(fb[3, 1, 0], fb[3, Lx, Ly]),
        torch.logaddexp(fb[4, 0, 1], fb[4, Lx, Ly]),
    ]) - total

    # transitions into M: f_k(i-1, j-1) + t[k,0] + match(i,j) + bM(i,j)
    mcell = match + b[0, 1:, 1:]                       # (Lx, Ly)
    t_k0 = torch.stack([
        _lse_all(f[k, :Lx, :Ly] + t[k, 0] + mcell) for k in range(5)
    ]) - total

    # gap transitions 0->2k+1 / (2k+1)->(2k+1) (x inserts), same for y
    def gap_counts(k):
        ex = insx[:, k]                                # emit x_i
        open_x = _lse_all(f[0, :Lx, :] + t[0, 2 * k + 1]
                          + ex[:, None] + b[2 * k + 1, 1:, :])
        ext_x = _lse_all(f[2 * k + 1, :Lx, :] + t[2 * k + 1, 2 * k + 1]
                         + ex[:, None] + b[2 * k + 1, 1:, :])
        ey = insy[:, k]
        open_y = _lse_all(f[0, :, :Ly] + t[0, 2 * k + 2]
                          + ey[None, :] + b[2 * k + 2, :, 1:])
        ext_y = _lse_all(f[2 * k + 2, :, :Ly] + t[2 * k + 2, 2 * k + 2]
                         + ey[None, :] + b[2 * k + 2, :, 1:])
        return open_x - total, ext_x - total, open_y - total, \
            ext_y - total

    # new initial distribution (should sum to ~2 before normalising)
    tot_init = torch.sum(torch.exp(init_counts))
    new_init = [torch.clamp(torch.exp(init_counts[0]) / tot_init, 0.0, 1.0)]
    for k in range(2):
        val = 0.5 * (torch.exp(init_counts[2 * k + 1])
                     + torch.exp(init_counts[2 * k + 2]))
        new_init += [torch.clamp(val / tot_init, 0.0, 1.0)] * 2

    gaps = [gap_counts(k) for k in range(2)]
    in_match = torch.exp(t_k0[0]) + sum(
        torch.exp(g[0]) + torch.exp(g[2]) for g in gaps
    )
    gap_open, gap_extend = [], []
    for k, (ox_, ex_, oy_, ey_) in enumerate(gaps):
        in_gap = (
            torch.exp(t_k0[2 * k + 1]) + torch.exp(ex_)
            + torch.exp(t_k0[2 * k + 2]) + torch.exp(ey_)
        )
        go = (torch.exp(ox_) + torch.exp(oy_)) / (2.0 * in_match)
        ge = (torch.exp(ex_) + torch.exp(ey_)) / in_gap
        gap_open += [go, go]
        gap_extend += [ge, ge]

    out = {"init": torch.stack(new_init), "gap_open": torch.stack(gap_open),
           "gap_extend": torch.stack(gap_extend)}

    if train_emissions:
        # pair emission posteriors at match cells; single emissions at
        # insert cells — scattered onto the 21-class alphabet
        post_m = torch.exp(
            torch.stack([
                f[k, :Lx, :Ly] + t[k, 0] + mcell for k in range(5)
            ]) - total
        ).sum(dim=0)                                    # (Lx, Ly)
        ohx = torch.nn.functional.one_hot(xl, 21).to(f.dtype)
        ohy = torch.nn.functional.one_hot(yl, 21).to(f.dtype)
        pair_counts = torch.einsum("ij,ia,jb->ab", post_m, ohx, ohy)
        pair_counts = pair_counts + pair_counts.T       # symmetrised
        single = torch.zeros(21, dtype=f.dtype, device=f.device)
        for k in range(2):
            px = torch.exp(
                torch.logaddexp(
                    torch.logsumexp(
                        f[0, :Lx, :] + t[0, 2 * k + 1]
                        + insx[:, k][:, None] + b[2 * k + 1, 1:, :],
                        dim=1,
                    ),
                    torch.logsumexp(
                        f[2 * k + 1, :Lx, :]
                        + t[2 * k + 1, 2 * k + 1]
                        + insx[:, k][:, None] + b[2 * k + 1, 1:, :],
                        dim=1,
                    ),
                ) - total
            )
            py = torch.exp(
                torch.logaddexp(
                    torch.logsumexp(
                        f[0, :, :Ly] + t[0, 2 * k + 2]
                        + insy[:, k][None, :] + b[2 * k + 2, :, 1:],
                        dim=0,
                    ),
                    torch.logsumexp(
                        f[2 * k + 2, :, :Ly]
                        + t[2 * k + 2, 2 * k + 2]
                        + insy[:, k][None, :] + b[2 * k + 2, :, 1:],
                        dim=0,
                    ),
                ) - total
            )
            single = single + ohx.T @ px + ohy.T @ py
        # reference normalises by the upper-triangle-plus-diagonal total
        # of the symmetrised count matrix (ProbabilisticModel.h:757-760)
        tot_pairs = 0.5 * (torch.sum(pair_counts)
                           + torch.sum(torch.diag(pair_counts)))
        out["emit_pairs"] = pair_counts / torch.clamp(tot_pairs, min=1e-30)
        out["emit_single"] = single / torch.clamp(torch.sum(single),
                                                  min=1e-30)
    return out
