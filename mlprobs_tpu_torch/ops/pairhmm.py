"""Pair-HMM forward/backward/posterior as batched row scans (plain
PyTorch).

Implements both posterior models of the reference base aligner
(baseMSA ProbabilisticModel.h):

* 5-state double-affine pair-HMM (`hmm5_*`) — states M, X1, Y1, X2, Y2;
  fwd: ProbabilisticModel.h:153-274, bwd: :292-395, total: :405-454,
  posterior: :464-493.
* 3-state local pair-HMM with flanking random states (`local_*`) — the
  odds-ratio formulation where all emissions are divided by the random
  background; same file, `flag=false` branches.

The PyTorch twin of the JAX package's `ops/pairhmm.py`: a Python loop
over rows carries the previous row of every state.  States consuming x
depend only on the previous row (element-wise); states consuming y
satisfy a first-order affine recurrence within the row, resolved in
O(log L) tensor steps (ops/semiring.py).  Every function takes a batch:
x (B, Lx) and y (B, Ly) padded class indices, lx and ly (B,) true
lengths; the backward pass masks any contribution that would consume a
padded position.  `p` holds the model's log tables as tensors on the
batch's device; the DP runs in their dtype (the JAX package's in
float32; the `scan` posterior engine takes float64).  This is an
independent formulation of the posteriors that the wavefront kernels
compute.
"""
from __future__ import annotations

import torch

from mlprobs_tpu_torch.ops.semiring import (
    LOG_ZERO,
    affine_scan_log,
    shift_left,
    shift_right,
)


def _lse(*terms):
    out = terms[0]
    for t in terms[1:]:
        out = torch.logaddexp(out, t)
    return out


def _at(rows, idx):
    """rows[b, idx[b]] of a (B, L) tensor."""
    return rows.gather(1, idx.long()[:, None])[:, 0]


def _masked(term, ok):
    return torch.where(ok, term, LOG_ZERO)


def _match_rows(x, y, lmatch):
    """(B, Lx, Ly+1) log match emissions; row i-1, position j =
    match(x_i, y_j).  Position 0 of each row is LOG_ZERO (the j=0 grid
    column emits nothing)."""
    m = lmatch[x[:, :, None], y[:, None, :]]
    return torch.cat([torch.full_like(m[:, :, :1], LOG_ZERO), m], dim=2)


def _valid_plane(post, lx, ly):
    """Zero the cells of a (B, Lx, Ly) plane outside (lx, ly)."""
    dev = post.device
    ivalid = torch.arange(post.shape[1], device=dev)[None, :, None] \
        < lx[:, None, None]
    jvalid = torch.arange(post.shape[2], device=dev)[None, None, :] \
        < ly[:, None, None]
    return torch.where(ivalid & jvalid, post, 0.0)


# --------------------------------------------------------------------------
# 5-state double-affine model
# --------------------------------------------------------------------------


def hmm5_forward(x, y, lx, ly, p):
    """Forward pass.  Returns (fM plane (B, Lx+1, Ly+1), states_at_ly
    (B, Lx+1, 5)).

    states_at_ly[:, i] holds the five forward values at grid cell
    (i, ly); row `lx` of it gives the terminal cell for the total.
    """
    x, y = x.long(), y.long()
    B, Lx = x.shape
    Ly = y.shape[1]
    dev = x.device
    t, init = p["trans"], p["init"]
    match = _match_rows(x, y, p["lmatch"])            # (B, Lx, Ly+1)
    insx = p["lins"][x]                               # (B, Lx, 2)
    # ins emission of y_j at row position j (position 0 unused)
    insy = p["lins"][y]
    insy_row = torch.cat([torch.full_like(insy[:, :1], LOG_ZERO), insy],
                         dim=1)                       # (B, Ly+1, 2)
    jidx = torch.arange(Ly + 1, device=dev)
    zero_row = torch.full((B, Ly + 1), LOG_ZERO, dtype=t.dtype, device=dev)

    # row 0: only Y states are reachable (injections at (0,1))
    def y0_row(k):
        c = torch.where(jidx == 1, init[2 * k + 2] + insy_row[:, :, k],
                        LOG_ZERO)
        d = insy_row[:, :, k] + t[2 * k + 2, 2 * k + 2]
        u = affine_scan_log(c[:, 1:], d[:, 1:])
        return torch.cat([zero_row[:, :1], u], dim=1)

    carry = (zero_row, zero_row, y0_row(0), zero_row, y0_row(1))
    m_rows = [zero_row]
    s_rows = [torch.stack([_at(r, ly) for r in carry], dim=1)]
    for i in range(1, Lx + 1):
        pM, pX1, pY1, pX2, pY2 = carry
        mrow = match[:, i - 1]
        ix = insx[:, i - 1]

        # M: from all 5 states at (i-1, j-1), plus the (1,1) injection
        rec = _lse(
            shift_right(pM) + t[0, 0],
            shift_right(pX1) + t[1, 0],
            shift_right(pY1) + t[2, 0],
            shift_right(pX2) + t[3, 0],
            shift_right(pY2) + t[4, 0],
        )
        inj_m = torch.where((jidx == 1) & (i == 1), init[0], LOG_ZERO)
        M = mrow + torch.logaddexp(rec, inj_m)

        # X states: element-wise from previous row, injection at (1,0)
        def x_state(k, pXk):
            inj = torch.where((jidx == 0) & (i == 1), init[2 * k + 1],
                              LOG_ZERO)
            return ix[:, k, None] + _lse(
                pM + t[0, 2 * k + 1], pXk + t[2 * k + 1, 2 * k + 1], inj
            )

        X1 = x_state(0, pX1)
        X2 = x_state(1, pX2)

        # Y states: within-row affine recurrence (from M at (i, j-1))
        Mshift = shift_right(M)

        def y_state(k):
            c = insy_row[:, :, k] + t[0, 2 * k + 2] + Mshift
            d = insy_row[:, :, k] + t[2 * k + 2, 2 * k + 2]
            u = affine_scan_log(c[:, 1:], d[:, 1:])
            return torch.cat([zero_row[:, :1], u], dim=1)

        carry = (M, X1, y_state(0), X2, y_state(1))
        m_rows.append(M)
        s_rows.append(torch.stack([_at(r, ly) for r in carry], dim=1))
    return torch.stack(m_rows, dim=1), torch.stack(s_rows, dim=1)


def hmm5_backward(x, y, lx, ly, p):
    """Backward pass.  Returns (bM plane, start_cells (B, Lx+1, 4)).

    start_cells[:, i] = [bX1(i,0), bX2(i,0), bY1(i,1), bY2(i,1)]; rows 1
    and 0 give the values needed for the backward total probability.
    """
    x, y = x.long(), y.long()
    B, Lx = x.shape
    Ly = y.shape[1]
    dev = x.device
    t, init = p["trans"], p["init"]
    # chars at position i+1 / j+1 (grid-indexed); pad with unknown class
    pad = torch.full((B, 1), 20, dtype=torch.long, device=dev)
    xn = torch.cat([x, pad], dim=1)
    yn = torch.cat([y, pad], dim=1)
    # match(i+1, j+1) laid out at (row i, pos j)
    match_next = p["lmatch"][xn[:, :, None], yn[:, None, :]]
    insx_next = p["lins"][xn]                         # (B, Lx+1, 2)
    insy_next = p["lins"][yn]                         # (B, Ly+1, 2)
    jidx = torch.arange(Ly + 1, device=dev)
    yvalid = jidx[None, :] < ly[:, None]   # consuming y at j+1 is allowed
    zero_row = torch.full((B, Ly + 1), LOG_ZERO, dtype=t.dtype, device=dev)

    carry = (zero_row,) * 5
    m_rows, s_rows = [], []
    for i in range(Lx, -1, -1):
        nM, nX1, nY1, nX2, nY2 = carry   # rows at i+1 (garbage at i == Lx)
        xvalid = (i < lx)[:, None]        # consuming x at i+1 is allowed
        at_terminal = (i == lx)[:, None]
        inj = torch.where(at_terminal & (jidx[None, :] == ly[:, None]),
                          0.0, zero_row)

        # match contribution base: match(i+1, j+1) + bM(i+1, j+1)
        mterm = _masked(match_next[:, i] + shift_left(nM), xvalid & yvalid)

        # Y states first: within-row right-to-left affine recurrence
        def y_state(k):
            c = torch.logaddexp(mterm + t[2 * k + 2, 0],
                                inj + init[2 * k + 2])
            d = _masked(insy_next[:, :, k] + t[2 * k + 2, 2 * k + 2],
                        yvalid)
            return affine_scan_log(c, d, reverse=True)

        Y1 = y_state(0)
        Y2 = y_state(1)

        def x_state(k, nXk):
            return _lse(
                mterm + t[2 * k + 1, 0],
                _masked(insx_next[:, i, k, None] + nXk
                        + t[2 * k + 1, 2 * k + 1], xvalid),
                inj + init[2 * k + 1],
            )

        X1 = x_state(0, nX1)
        X2 = x_state(1, nX2)

        M = _lse(
            mterm + t[0, 0],
            _masked(insx_next[:, i, 0, None] + nX1 + t[0, 1], xvalid),
            _masked(insx_next[:, i, 1, None] + nX2 + t[0, 3], xvalid),
            _masked(insy_next[:, :, 0] + shift_left(Y1) + t[0, 2], yvalid),
            _masked(insy_next[:, :, 1] + shift_left(Y2) + t[0, 4], yvalid),
            inj + init[0],
        )

        carry = (M, X1, Y1, X2, Y2)
        m_rows.append(M)
        s_rows.append(torch.stack([X1[:, 0], X2[:, 0], Y1[:, 1], Y2[:, 1]],
                                  dim=1))
    return torch.stack(m_rows[::-1], dim=1), torch.stack(s_rows[::-1], dim=1)


def hmm5_posterior(x, y, lx, ly, p):
    """Match posterior planes, 0-based: out[b, i-1, j-1] = P(x_i ~ y_j).

    Shape (B, Lx, Ly); cells outside (lx, ly) are zero.
    """
    fM, fstates = hmm5_forward(x, y, lx, ly, p)
    bM, bstarts = hmm5_backward(x, y, lx, ly, p)
    x, y = x.long(), y.long()
    init, lins = p["init"], p["lins"]
    B = x.shape[0]
    b = torch.arange(B, device=x.device)
    total_f = torch.logsumexp(fstates[b, lx.long()] + init, dim=-1)
    # backward total: paths re-assembled at the three start cells
    m11 = p["lmatch"][x[:, 0], y[:, 0]]
    total_b = _lse(
        bM[:, 1, 1] + init[0] + m11,
        bstarts[:, 1, 0] + init[1] + lins[x[:, 0], 0],
        bstarts[:, 1, 1] + init[3] + lins[x[:, 0], 1],
        bstarts[:, 0, 2] + init[2] + lins[y[:, 0], 0],
        bstarts[:, 0, 3] + init[4] + lins[y[:, 0], 1],
    )
    total = 0.5 * (total_f + total_b)
    lpost = fM + bM - total[:, None, None]
    post = torch.exp(torch.clamp(lpost, max=0.0))[:, 1:, 1:]
    return _valid_plane(post, lx, ly)


# --------------------------------------------------------------------------
# 3-state local model (odds-ratio form)
# --------------------------------------------------------------------------


def _local_tables(x, y, p):
    """(B, Lx, Ly+1) odds-ratio match emissions mp'(i,j) = match -
    ins_x - ins_y."""
    mp = p["lmatch"][x[:, :, None], y[:, None, :]]
    mp = mp - p["lins"][x][:, :, None] - p["lins"][y][:, None, :]
    return torch.cat([torch.full_like(mp[:, :, :1], LOG_ZERO), mp], dim=2)


def local_forward(x, y, lx, ly, p):
    """Forward pass of the local model.  Returns (fM plane, total_f)."""
    x, y = x.long(), y.long()
    B, Lx = x.shape
    Ly = y.shape[1]
    dev = x.device
    lt, rt1 = p["trans"], p["log_stay"]
    mrows = _local_tables(x, y, p)
    jidx = torch.arange(Ly + 1, device=dev)
    zero_row = torch.full((B, Ly + 1), LOG_ZERO, dtype=lt.dtype, device=dev)
    jvalid = (jidx[None, :] >= 1) & (jidx[None, :] <= ly[:, None])

    pM = pX = pY = zero_row
    tot = zero_row[:, 0]
    m_rows = [zero_row]
    for i in range(1, Lx + 1):
        mrow = mrows[:, i - 1]
        # M: start-anywhere term plus transitions from (i-1, j-1)
        rec = _lse(
            shift_right(pM) + lt[0, 0],
            shift_right(pX) + lt[1, 0],
            shift_right(pY) + lt[2, 0],
        )
        M = mrow - 2 * rt1 + torch.logaddexp(torch.zeros_like(rec), rec)
        M = torch.where(jidx >= 1, M, LOG_ZERO)
        X = torch.logaddexp(pM + lt[0, 1] - rt1, pX + lt[1, 1] - rt1)
        # Y within-row recurrence
        Mshift = shift_right(M)
        c = Mshift + lt[0, 2] - rt1
        d = (lt[2, 2] - rt1).expand_as(c)
        Y = torch.cat([zero_row[:, :1], affine_scan_log(c[:, 1:], d[:, 1:])],
                      dim=1)
        here = jvalid & (i <= lx)[:, None]
        tot = torch.logaddexp(
            tot, torch.logsumexp(torch.where(here, M, LOG_ZERO), dim=1))
        pM, pX, pY = M, X, Y
        m_rows.append(M)
    return torch.stack(m_rows, dim=1), tot


def local_backward(x, y, lx, ly, p):
    """Backward pass of the local model.  Returns (bM plane, total_b)."""
    x, y = x.long(), y.long()
    B, Lx = x.shape
    Ly = y.shape[1]
    dev = x.device
    lt, rt1 = p["trans"], p["log_stay"]
    pad = torch.full((B, 1), 20, dtype=torch.long, device=dev)
    xn = torch.cat([x, pad], dim=1)
    yn = torch.cat([y, pad], dim=1)
    mp_next = (
        p["lmatch"][xn[:, :, None], yn[:, None, :]]
        - p["lins"][xn][:, :, None]
        - p["lins"][yn][:, None, :]
    )                                                 # (B, Lx+1, Ly+1)
    # odds-ratio emission at the cell itself, for the total
    mp_here = _local_tables(x, y, p)                  # (B, Lx, Ly+1)
    jidx = torch.arange(Ly + 1, device=dev)
    yvalid = jidx[None, :] < ly[:, None]
    hvalid = (jidx[None, :] >= 1) & (jidx[None, :] <= ly[:, None])
    zero_row = torch.full((B, Ly + 1), LOG_ZERO, dtype=lt.dtype, device=dev)

    nM = nX = zero_row
    tot = zero_row[:, 0]
    m_rows = []
    for i in range(Lx, -1, -1):
        xvalid = (i < lx)[:, None]
        mterm = _masked(mp_next[:, i] + shift_left(nM), xvalid & yvalid)

        c = mterm + lt[2, 0] - 2 * rt1
        d = _masked((lt[2, 2] - rt1).expand_as(c), yvalid)
        Y = affine_scan_log(c, d, reverse=True)

        X = torch.logaddexp(
            mterm + lt[1, 0] - 2 * rt1,
            _masked(nX + lt[1, 1] - rt1, xvalid),
        )
        M = _lse(
            torch.zeros_like(mterm),                   # end anywhere
            mterm + lt[0, 0] - 2 * rt1,
            _masked(nX + lt[0, 1] - rt1, xvalid),
            _masked(shift_left(Y) + lt[0, 2] - rt1, yvalid),
        )
        # total_b term: bM(i,j) + mp'(i,j) - 2*rt1 over valid cells
        mp_row = mp_here[:, max(i - 1, 0)]
        here = hvalid & ((i >= 1) & (i <= lx))[:, None]
        tot = torch.logaddexp(tot, torch.logsumexp(
            torch.where(here, M + mp_row - 2 * rt1, LOG_ZERO), dim=1))
        nM, nX = M, X
        m_rows.append(M)
    return torch.stack(m_rows[::-1], dim=1), tot


def local_posterior(x, y, lx, ly, p):
    """Match posterior planes of the local model, 0-based (B, Lx, Ly)."""
    fM, total_f = local_forward(x, y, lx, ly, p)
    bM, total_b = local_backward(x, y, lx, ly, p)
    total = 0.5 * (total_f + total_b)
    lpost = fM + bM - total[:, None, None]
    post = torch.exp(torch.clamp(lpost, max=0.0))[:, 1:, 1:]
    return _valid_plane(post, lx, ly)
