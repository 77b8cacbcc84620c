# Frozen copy of mlprobs_tpu_torch/ops/wavefront.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Anti-diagonal wavefront DP engine in scaled probability space (plain
PyTorch).

The PyTorch twin of the JAX package's `ops/wavefront.py`, with the same
contract and the same arithmetic, one tensor op at a time:

* **Skewed layout** — diagonal d (= i + j) is one (B, W) row; lane j
  holds grid cell (i = d - j, j).  The DP dependencies (i-1, j-1),
  (i-1, j) and (i, j-1) are rows d-2 (lane j-1) and d-1 (lanes j, j-1).
* **Scaled probability space** — after each diagonal the states are
  rescaled by an exact power of two; the log2 scale S is kept per pair
  per diagonal (stored = true * 2^S).
* **Backward = forward on reversed sequences** — the reverse pass runs
  the forward recurrences on right-aligned reversed sequences with
  transposed transitions and emits the pre-emission M accumulator, so
  bwd(i, j) = rev[2*Lp+2-d, Lp+1-j] is a static remap.

Each `lax.scan` of the JAX version is a Python loop over diagonals here.
This module is the plain version of the CUDA kernels: `sweep` and
`combine` (`ops/kernels/wavefront_kernel.py`), and the feature pass's
Viterbi, `viterbi_wavefront` with `viterbi_path_stats`
(`ops/kernels/viterbi_kernel.py`).  The CPU path runs it, and the chip
check holds the kernels against it on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PAD = 20  # padding alphabet class; all prob tables are zero for it
TINY = 1e-38
LOG_ZERO = -1e30


def _shift1(v):
    """lane j -> value from lane j-1 (zero-fill): the (., j-1) dependency."""
    return F.pad(v[..., :-1], (1, 0))


def _rescale(states, s_prev):
    """Per-pair exact power-of-two renormalisation of a state tuple."""
    mx = states[0]
    for v in states[1:]:
        mx = torch.maximum(mx, v)
    mx = mx.amax(dim=1)                                  # (B,)
    e = torch.where(
        mx > 0, torch.floor(torch.log2(torch.clamp(mx, min=TINY))),
        torch.zeros_like(mx),
    )
    f = torch.exp2(-e)
    return tuple(v * f[:, None] for v in states), f, s_prev - e


def _feeds(xp, yp):
    """(xfeed (B, 3Lp+2), ygrid (B, W)) long class arrays.

    xfeed[:, 2Lp+1-d : 2Lp+1-d+W] is diagonal d's x row: lane j holds
    x_{d-j} (1-indexed), PAD outside the sequence."""
    B, Lp = xp.shape
    xl = xp.long()
    padb = torch.full((B, Lp + 1), PAD, dtype=torch.long, device=xp.device)
    xfeed = torch.cat([padb, xl.flip(1), padb], dim=1)
    ygrid = torch.cat([padb[:, :1], yp.long()], dim=1)
    return xfeed, ygrid


def wavefront_forward(xp, yp, ox, oy, lx, ly, tables,
                      models=("hmm5",), emit_pre=False):
    """Fused multi-model forward wavefront over one padded pair batch.

    xp/yp: (B, Lp) int8 class tensors, PAD beyond the embedded sequence.
    ox/oy: (B,) int32 embedding offsets (0 for the forward pass;
           Lp - lx / Lp - ly for the right-aligned reversed pass).
    lx/ly: (B,) true lengths.
    tables: dict model -> prob tables (models.params.tables_from_numpy).
    emit_pre: emit the pre-emission M accumulator (reverse-pass mode)
           instead of the post-emission M / Zm plane.

    Returns dict with, per model m:
      planes[m]: (D, B, W) f32,
      scales[m]: (D, B) f32 cumulative log2 scale S (stored=true*2^S),
      log2t[m]:  (B,) f32 log2 of the model's total probability.
    D = 2*Lp + 1, W = Lp + 1; plane row d, lane j = grid cell (d-j, j).
    """
    B, Lp = xp.shape
    W = Lp + 1
    D = 2 * Lp + 1
    dev = xp.device
    lane = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    xfeed, ygrid = _feeds(xp, yp)

    ox, oy = ox.to(torch.int32), oy.to(torch.int32)
    lx, ly = lx.to(torch.int32), ly.to(torch.int32)
    oxc, oyc = ox[:, None], oy[:, None]
    lane_oy = lane == oyc
    lane_oy1 = lane == oyc + 1
    lane_end = lane == (oyc + ly[:, None])
    term_sel = lane_end.to(torch.float32)
    dterm = ox + lx + oy + ly

    zero = torch.zeros((B, W), dtype=torch.float32, device=dev)
    zs = torch.zeros((B,), dtype=torch.float32, device=dev)
    ones = torch.ones((B,), dtype=torch.float32, device=dev)

    planes = {m: torch.empty((D, B, W), dtype=torch.float32, device=dev)
              for m in models}
    scales = {m: torch.empty((D, B), dtype=torch.float32, device=dev)
              for m in models}

    def capture(row):
        return (row * term_sel).sum(dim=1)

    st = {}
    if "hmm5" in models:
        t5 = tables["hmm5"]
        T5, init5 = t5["T"], t5["init"]
        pm5 = t5["pm"].reshape(-1)
        iy = t5["pins"][ygrid]                            # (B, W, 2)
        st["hmm5"] = {"d1": (zero,) * 5, "d2": (zero,) * 5, "r": ones,
                      "s1": zs, "term": (zs,) * 5, "sterm": zs}
    if "local" in models:
        tl = tables["local"]
        TL, c1, c2 = tl["T"], tl["c1"], tl["c2"]
        pml = tl["pm"].reshape(-1)
        st["local"] = {"d1": (zero,) * 3, "d2": (zero,) * 3, "r": ones,
                       "s1": zs,
                       "acc": torch.full((B,), -torch.inf, device=dev)}
    if "partition" in models:
        tp = tables["partition"]
        go, ge = tp["go"], tp["ge"]
        pmp = tp["pm"].reshape(-1)
        st["partition"] = {"d1": (zero,) * 3, "d2": (zero,) * 3,
                           "r": ones, "s1": zs, "term": (zs,) * 3,
                           "sterm": zs}

    for d in range(D):
        start = 2 * Lp + 1 - d
        xrow = xfeed[:, start:start + W]
        pair_idx = xrow * 21 + ygrid                      # pm[x, y]
        irow = d - lane
        at_term = (dterm == d)

        if "hmm5" in models:
            c = st["hmm5"]
            m1, x11, y11, x21, y21 = c["d1"]
            m2, x12, y12, x22, y22 = c["d2"]
            rc, s1 = c["r"][:, None], c["s1"]
            em = pm5[pair_idx]
            ix = t5["pins"][xrow]
            e2s1 = torch.exp2(s1)[:, None]
            inj_m = torch.where(
                (d == ox + oy + 2)[:, None] & lane_oy1,
                init5[0] * e2s1, 0.0,
            )
            am = (
                _shift1(m2) * T5[0, 0]
                + _shift1(x12) * T5[1, 0]
                + _shift1(y12) * T5[2, 0]
                + _shift1(x22) * T5[3, 0]
                + _shift1(y22) * T5[4, 0]
            ) * rc + inj_m
            m_new = em * am
            injx = (d == ox + oy + 1)[:, None] & lane_oy
            x1_new = ix[:, :, 0] * (
                m1 * T5[0, 1] + x11 * T5[1, 1]
                + torch.where(injx, init5[1] * e2s1, 0.0)
            )
            x2_new = ix[:, :, 1] * (
                m1 * T5[0, 3] + x21 * T5[3, 3]
                + torch.where(injx, init5[3] * e2s1, 0.0)
            )
            injy = (d == ox + oy + 1)[:, None] & lane_oy1
            y1_new = iy[:, :, 0] * (
                _shift1(m1) * T5[0, 2] + _shift1(y11) * T5[2, 2]
                + torch.where(injy, init5[2] * e2s1, 0.0)
            )
            y2_new = iy[:, :, 1] * (
                _shift1(m1) * T5[0, 4] + _shift1(y21) * T5[4, 4]
                + torch.where(injy, init5[4] * e2s1, 0.0)
            )
            states, f, s_new = _rescale(
                (m_new, x1_new, y1_new, x2_new, y2_new), s1
            )
            c["term"] = tuple(
                torch.where(at_term, capture(v), t)
                for t, v in zip(c["term"], states)
            )
            c["sterm"] = torch.where(at_term, s_new, c["sterm"])
            c["d2"], c["d1"] = c["d1"], states
            c["r"], c["s1"] = f, s_new
            planes["hmm5"][d] = (am * f[:, None]) if emit_pre else states[0]
            scales["hmm5"][d] = s_new

        if "local" in models:
            c = st["local"]
            lm1, lxs1, lys1 = c["d1"]
            lm2, lxs2, lys2 = c["d2"]
            rc, s1 = c["r"][:, None], c["s1"]
            em = pml[pair_idx]
            e2s1 = torch.exp2(s1)[:, None]
            # start-anywhere "1" is valid only inside the true grid
            inb = (
                (irow > oxc) & (irow <= oxc + lx[:, None])
                & (lane > oyc) & (lane <= oyc + ly[:, None])
            )
            am = (
                _shift1(lm2) * TL[0, 0]
                + _shift1(lxs2) * TL[1, 0]
                + _shift1(lys2) * TL[2, 0]
            ) * rc + torch.where(inb, e2s1, 0.0)
            m_new = em * c2 * am
            x_new = c1 * (lm1 * TL[0, 1] + lxs1 * TL[1, 1])
            y_new = c1 * (_shift1(lm1) * TL[0, 2] + _shift1(lys1) * TL[2, 2])
            states, f, s_new = _rescale((m_new, x_new, y_new), s1)
            rowsum = states[0].sum(dim=1)
            term = torch.where(
                rowsum > 0,
                torch.log2(torch.clamp(rowsum, min=TINY)) - s_new,
                -torch.inf,
            )
            c["acc"] = torch.logaddexp2(c["acc"], term)
            c["d2"], c["d1"] = c["d1"], states
            c["r"], c["s1"] = f, s_new
            planes["local"][d] = (am * f[:, None]) if emit_pre else states[0]
            scales["local"][d] = s_new

        if "partition" in models:
            c = st["partition"]
            zm1, ze1, zf1 = c["d1"]
            zm2, ze2, zf2 = c["d2"]
            rc, s1 = c["r"][:, None], c["s1"]
            em = pmp[pair_idx]
            e2s1 = torch.exp2(s1)[:, None]
            row0 = irow == oxc
            col0 = lane_oy
            x_done = irow == oxc + lx[:, None]
            inb = (
                (irow >= oxc) & (irow <= oxc + lx[:, None])
                & (lane >= oyc) & (lane <= oyc + ly[:, None])
            )
            am = _shift1(zm2 + ze2 + zf2) * rc
            zm_new = em * am
            zm_new = torch.where(row0 & col0 & inb, e2s1, zm_new)
            gof = torch.where(col0 | lane_end, 1.0, go)
            gef = torch.where(col0 | lane_end, 1.0, ge)
            zf_new = zm1 * gof + zf1 * gef
            zf_new = torch.where(col0 & (irow > oxc), e2s1, zf_new)
            goe = torch.where(x_done, 1.0, go)
            gee = torch.where(x_done, 1.0, ge)
            ze_new = _shift1(zm1) * goe + _shift1(ze1) * gee
            ze_new = torch.where(row0 & (lane > oyc), e2s1, ze_new)
            zm_new = torch.where(inb, zm_new, 0.0)
            zf_new = torch.where(inb, zf_new, 0.0)
            ze_new = torch.where(inb, ze_new, 0.0)
            am = torch.where(inb, am, 0.0)
            states, f, s_new = _rescale((zm_new, ze_new, zf_new), s1)
            c["term"] = tuple(
                torch.where(at_term, capture(v), t)
                for t, v in zip(c["term"], states)
            )
            c["sterm"] = torch.where(at_term, s_new, c["sterm"])
            c["d2"], c["d1"] = c["d1"], states
            c["r"], c["s1"] = f, s_new
            planes["partition"][d] = (
                (am * f[:, None]) if emit_pre else states[0]
            )
            scales["partition"][d] = s_new

    log2t = {}
    if "hmm5" in models:
        c = st["hmm5"]
        tot = 0
        for t, w in zip(c["term"], init5):
            tot = tot + t * w
        log2t["hmm5"] = (
            torch.log2(torch.clamp(tot, min=TINY)) - c["sterm"]
        )
    if "local" in models:
        log2t["local"] = st["local"]["acc"]
    if "partition" in models:
        c = st["partition"]
        tot = c["term"][0] + c["term"][1] + c["term"][2]
        log2t["partition"] = (
            torch.log2(torch.clamp(tot, min=TINY)) - c["sterm"]
        )
    return {"planes": planes, "scales": scales, "log2t": log2t}


def _align_rev(plane):
    """Static remap: out[d, ..., j] = plane[2*Lp + 2 - d, ..., Lp + 1 - j].

    plane: (D, B, W).  Rows d<2 and lane 0 of the result are zero-filled
    (they correspond to cells outside the grid).
    """
    flipped = plane.flip(0).flip(-1)
    shifted = F.pad(flipped[:-2], (0, 0) * (plane.ndim - 1) + (2, 0))
    return F.pad(shifted[..., :-1], (1, 0))


def _align_rev_scales(s):
    """Same D-axis remap for (D, B) scale rows."""
    return F.pad(s.flip(0)[:-2], (0, 0, 2, 0))


def posterior_skew(fwd, rev, model):
    """Skewed match-posterior plane from a fwd and a reverse-pass result.

    p[d, b, j] = P(x_{d-j} ~ y_j), clamped to [0, 1]; exact zeros
    outside the valid grid.  Totals: hmm5/local average the two
    independently computed totals (ProbabilisticModel.h:464-493);
    partition uses the forward total (MSAPartProbs.cpp ComputePostProbs).

    The scale terms are summed first: sf + sr + l2t cancels to a small
    number, while sf and sr alone reach thousands after a few hundred
    diagonals, where an f32 sum rounds at ~2e-4 in log2.
    """
    fp = fwd["planes"][model]
    rp = _align_rev(rev["planes"][model])
    sf = fwd["scales"][model]
    sr = _align_rev_scales(rev["scales"][model])
    if model == "partition":
        l2t = fwd["log2t"][model]
    else:
        l2t = 0.5 * (fwd["log2t"][model] + rev["log2t"][model])
    t = sf + sr + l2t[None, :]
    lp = (
        torch.log2(torch.clamp(fp, min=TINY))
        + torch.log2(torch.clamp(rp, min=TINY))
        - t[:, :, None]
    )
    lp = torch.where((fp > 0) & (rp > 0), lp, -torch.inf)
    return torch.exp2(torch.clamp(lp, max=0.0))


def mwt_skew(p_skew, lx, ly, with_matches=False):
    """MWT accuracy DP over a skewed posterior plane (fwd coordinates).

    Returns score (B,) or (score, nmatches (B,)): the maximum expected
    accuracy and the number of diagonal moves on the optimal path, as a
    carried DP (ProbabilisticModel.h:804-864, MSA.cpp:1745-1752).
    Tie-breaking: diag >= left >= up (ScoreType.h ChooseBestOfThree).
    """
    D, B, W = p_skew.shape
    dev = p_skew.device
    lane = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    dterm = (lx + ly).to(torch.int32)
    term_sel = (lane == ly[:, None]).to(torch.float32)
    zero = torch.zeros((B, W), dtype=torch.float32, device=dev)
    zs = torch.zeros((B,), dtype=torch.float32, device=dev)
    s1 = s2 = n1 = n2 = zero
    score, nb = zs, zs
    for d in range(D):
        prow = p_skew[d]
        irow = d - lane
        pd = prow + _shift1(s2)
        left = _shift1(s1)
        up = s1
        take_d = (pd >= left) & (pd >= up)
        take_l = left >= up
        s_new = torch.where(take_d, pd, torch.where(take_l, left, up))
        boundary = (irow <= 0) | (lane == 0)
        s_new = torch.where(boundary, 0.0, s_new)
        at_term = dterm == d
        score = torch.where(at_term, (s_new * term_sel).sum(dim=1), score)
        if with_matches:
            nd = _shift1(n2) + 1.0
            nl = _shift1(n1)
            n_new = torch.where(take_d, nd, torch.where(take_l, nl, n1))
            n_new = torch.where(boundary, 0.0, n_new)
            nb = torch.where(at_term, (n_new * term_sel).sum(dim=1), nb)
            n1, n2 = n_new, n1
        s1, s2 = s_new, s1
    if with_matches:
        return score, nb
    return score


def unskew_posterior(p_skew):
    """(D, B, W) skewed posterior plane -> (B, Lp, Lp) grid plane.

    Grid cell (i, j) (0-based posterior entry) lives at skew row
    d = i + j + 2, lane j + 1.  A strided view of the contiguous plane
    (offset 2BW + 1, strides (W, BW, BW + 1)); the caller's threshold
    makes it contiguous.
    """
    D, B, W = p_skew.shape
    lp = W - 1
    p = p_skew.contiguous()
    return p.as_strided(
        (B, lp, lp), (W, B * W, B * W + 1), p.storage_offset() + 2 * B * W + 1
    )


def topk_skew(p_skew, k, cutoff):
    """Per-diagonal top-k sparsification of a skewed posterior plane.

    Returns (vals (D, B, k) f32, lanes (D, B, k) int32).  Entries below
    `cutoff` are zeroed (SparseMatrix.h:14).  Ties go to the lowest lane,
    as the JAX package's `lax.top_k` orders them: a stable descending
    sort, since `torch.topk` promises no order among equal values.
    """
    masked = torch.where(p_skew >= cutoff, p_skew, 0.0)
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].to(torch.int32)


# ---------------------------------------------------------------------------
# Viterbi (log-space max-plus wavefront)
# ---------------------------------------------------------------------------


def viterbi_wavefront(xp, yp, lx, ly, p, vinit):
    """3-state local-model Viterbi as a log-space max-plus wavefront.

    p: the local model's log tables {lmatch (21,21), lins (21,),
    trans (3,3)} as f32 tensors; vinit (3,) f32.  Same recurrences,
    tie-breaks and packed direction bits as the JAX package's
    `viterbi_wavefront` (ComputeViterbiAlignment,
    ProbabilisticModel.h:1043+).

    Returns (dirs (D, B, W) int8 skewed, end_state (B,) int32,
    score (B,) f32).  dirs[d, b, j] is grid cell (d - j, j).
    """
    B, Lp = xp.shape
    W = Lp + 1
    D = 2 * Lp + 1
    dev = xp.device
    lane = torch.arange(W, dtype=torch.int32, device=dev)[None, :]

    lm = p["lmatch"].clone()
    lm[PAD] = LOG_ZERO
    lm[:, PAD] = LOG_ZERO
    lm = lm.reshape(-1)
    lins = p["lins"].clone()
    lins[PAD] = LOG_ZERO
    lt = p["trans"]
    xfeed, ygrid = _feeds(xp, yp)
    liy = lins[ygrid]                                 # (B, W)

    dterm = (lx + ly).to(torch.int32)
    term_sel = (lane == ly[:, None]).to(torch.float32)
    zrow = torch.full((B, W), LOG_ZERO, dtype=torch.float32, device=dev)
    term = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    m1 = x1 = y1 = m2 = x2 = y2 = zrow
    dirs = torch.empty((D, B, W), dtype=torch.int8, device=dev)
    lane0 = lane == 0
    for d in range(D):
        start = 2 * Lp + 1 - d
        xrow = xfeed[:, start:start + W]
        em = lm[xrow * 21 + ygrid]
        lix = lins[xrow]

        cm = _shift1(m2) + lt[0, 0]
        cx = _shift1(x2) + lt[1, 0]
        cy = _shift1(y2) + lt[2, 0]
        m_new = em + torch.maximum(torch.maximum(cm, cx), cy)
        tb_m = torch.where(
            (cm >= cx) & (cm >= cy), 0, torch.where(cx >= cy, 1, 2)
        )
        from_m = m1 + lt[0, 1]
        from_x = x1 + lt[1, 1]
        x_new = lix + torch.maximum(from_m, from_x)
        tb_x = (from_m < from_x).to(torch.int64)
        # Y(i, j): both predecessors (M/Y at (i, j-1)) sit at diagonal
        # d-1, lane j-1
        ym = _shift1(m1) + lt[0, 2]
        yy = _shift1(y1) + lt[2, 2]
        y_new = liy + torch.maximum(ym, yy)
        tb_y = (ym < yy).to(torch.int64)

        if d == 0:
            m_new = torch.where(lane0, vinit[0], m_new)
            x_new = torch.where(lane0, vinit[1], x_new)
            y_new = torch.where(lane0, vinit[2], y_new)

        dirs[d] = (tb_m + 4 * tb_x + 8 * tb_y).to(torch.int8)
        at_term = (dterm == d)[:, None]
        cap = torch.stack(
            [(v * term_sel).sum(dim=1) for v in (m_new, x_new, y_new)],
            dim=1,
        )
        term = torch.where(at_term, cap, term)
        m2, x2, y2 = m1, x1, y1
        m1, x1, y1 = m_new, x_new, y_new

    final = term + vinit[None, :]
    end_state = torch.where(
        (final[:, 0] >= final[:, 1]) & (final[:, 0] >= final[:, 2]),
        0,
        torch.where(final[:, 1] >= final[:, 2], 1, 2),
    ).to(torch.int32)
    score = final.gather(1, end_state[:, None].long())[:, 0]
    return dirs, end_state, score


def viterbi_path_stats(dirs_skew, ends, xp, yp, lx, ly, blosum):
    """Traceback + feature accumulation over a Viterbi batch, on device.

    Walks every pair's optimal path in lockstep (one step per path
    position), accumulating the -G feature-pass quantities (MSA.cpp
    Alter_ModelAdjustmentTest) without moving the direction planes off
    the device.

    Returns (pathlen (B,) int32, matches (B,) int32,
             scores_rev (2*Lp, B) f32), scores_rev[t] = path position n-1-t.
    """
    D, B, W = dirs_skew.shape
    lp = W - 1
    dev = dirs_skew.device
    bl21 = blosum.to(torch.float32).reshape(-1)
    bidx = torch.arange(B, device=dev)
    xl, yl = xp.long(), yp.long()
    r = lx.long().clone()
    c = ly.long().clone()
    state = ends.long().clone()
    plen = torch.zeros((B,), dtype=torch.int32, device=dev)
    matches = torch.zeros((B,), dtype=torch.int32, device=dev)
    scores_rev = torch.empty((2 * lp, B), dtype=torch.float32, device=dev)
    for t in range(2 * lp):
        active = (r > 0) | (c > 0)
        dbits = dirs_skew[r + c, bidx, c].long()
        is_m = state == 0
        is_x = state == 1
        nxt = torch.where(
            is_m, dbits & 3,
            torch.where(
                is_x,
                torch.where((dbits & 4) != 0, 1, 0),
                torch.where((dbits & 8) != 0, 2, 0),
            ),
        )
        xc = xl[bidx, torch.clamp(r - 1, min=0)]
        yc = yl[bidx, torch.clamp(c - 1, min=0)]
        is_b = active & is_m
        matches = matches + (is_b & (xc == yc)).to(torch.int32)
        s = bl21[xc * 21 + yc]
        s = torch.where(
            is_b & (xc < PAD) & (yc < PAD) & (s < 10.0), s, 0.0
        )
        scores_rev[t] = s
        plen = plen + active.to(torch.int32)
        r = torch.where(active & (is_m | is_x), r - 1, r)
        c = torch.where(active & (is_m | (state == 2)), c - 1, c)
        state = torch.where(active, nxt, state)
    return plen, matches, scores_rev
