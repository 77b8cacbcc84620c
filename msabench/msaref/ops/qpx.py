# Frozen copy of mlprobs_tpu_torch/ops/qpx.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Reference-approximate QuickProbs HMM5 posterior ("qp-exact"), plain
PyTorch.

QuickProbs computes its 5-state pair-HMM forward/backward in float32
LOG space with POLYNOMIAL approximations: LOOKUP_FLOAT, a piecewise
cubic fit of log1p(exp(x)) on [0, 7.5] (ScoreType.h:185-212), inside
every LOG_ADD / LOG_PLUS_EQUALS, and a branch-polynomial EXP on
[-16, 0] for the posterior (ScoreType.h:40-60 active under
`typedef float ScoreType`).  The fit error is path-dependent, so the
scaled-probability sweep cannot reproduce the binary's posteriors; this
module replays the reference arithmetic operation for operation: the
same LOG_ADD orders, the same guards, the same LOG_ZERO = -2e20
absorption, each polynomial as separate f32 multiplies and adds.
`local_posterior_qpx` replays baseMSA's 3-state local model the same way
(the JAX package's function of that name; nothing in the pipeline calls
it).

Recurrence source: ParallelProbabilisticModel::computeForwardMatrix /
computeBackwardMatrix (ParallelProbabilisticModel.cpp:40-238),
posterior (ibid:240-273), called from PosteriorStage::computePairwise
(PosteriorStage.cpp:122-153).  The JAX package runs each direction as a
`lax.scan`; here each is a Python loop over anti-diagonals whose cells
get exactly the operations the scan gives them.  That loop is the plain
version of the qpx CUDA kernels (`ops/kernels/qpx_kernel.py`), which the
realigner runs on the card and which equal it bit for bit.  Only the loop's
bookkeeping differs: the four insert states are stacked and updated by
one tensor op where the reference applies the same operation to each,
a state is shifted by reading a view of a padded buffer, each piece of
a polynomial is picked by its interval before it is evaluated, and the
terminal cell is read by one gather.  None of that changes a cell's
value.

Plane convention matches ops/wavefront.py: (D, B, W) with
D = 2*Lp + 1, W = Lp + 1, row d lane j = grid cell (i = d - j, j),
1-indexed residues.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

PAD = 20
NCLS = 22                       # 21 residue classes + one all-LOG_ZERO class
OFF = 21                        # that class: the lane past the last one
LOG_ZERO = float(np.float32(-2e20))
HALF_LOG_ZERO = float(np.float32(-1e20))
THR = 7.5                       # LOG_UNDERFLOW_THRESHOLD

# LOOKUP_FLOAT pieces: x <= 1, <= 2.5, <= 4.5, else; (a, b, c, d) of
# ((a*x + b)*x + c)*x + d
_LOOKUP_BOUNDS = (1.0, 2.5, 4.5)
_LOOKUP_COEF = (
    (-0.009350833524763, 0.130659527668286,
     0.498799810682272, 0.693203116424741),
    (-0.014532321752540, 0.139942324101744,
     0.495635523139337, 0.692140569840976),
    (-0.004605031767994, 0.063427417320019,
     0.695956496475118, 0.514272634594009),
    (-0.000458661602210, 0.009695946122598,
     0.930734667215156, 0.168037164329057),
)
# EXP pieces: x <= -16 (0), <= -8, <= -4, <= -2, <= -1, <= -0.5, <= 0,
# then exp(x); (a, b, c, d, e) of (((a*x + b)*x + c)*x + d)*x + e
_EXP_BOUNDS = (-16.0, -8.0, -4.0, -2.0, -1.0, -0.5, 0.0)
_EXP_COEF = (
    (0.0, 0.0, 0.0, 0.0, 0.0),
    (0.00000051741713416603, 0.00002721456879608080,
     0.00053418601865636800, 0.00464101989351936000,
     0.01507447981459420000),
    (0.00012398771025456900, 0.00349155785951272000,
     0.03727721426017900000, 0.17974997741536900000,
     0.33249299994217400000),
    (0.00217245711583303000, 0.03484829428350620000,
     0.22118199801337800000, 0.67049462206469500000,
     0.83556950223398500000),
    (0.00940528203591384000, 0.09414963667859410000,
     0.40825793595877300000, 0.93933625499130400000,
     0.98369508190545300000),
    (0.01973899026052090000, 0.13822379685007000000,
     0.48056651562365000000, 0.99326940370383500000,
     0.99906756856399500000),
    (0.03254409303190190000, 0.16280432765779600000,
     0.49929760485974900000, 0.99995149601363700000,
     0.99999925508501600000),
    (0.0, 0.0, 0.0, 0.0, 0.0),
)
# rows of the posterior computed at once: bounds the temporaries
_POST_CHUNK = 64


@functools.lru_cache(maxsize=8)
def _consts(device: torch.device) -> dict:
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return {"lb": f32(_LOOKUP_BOUNDS), "lc": f32(_LOOKUP_COEF),
            "eb": f32(_EXP_BOUNDS), "ec": f32(_EXP_COEF)}


def lookup_float(x):
    """Piecewise-cubic log1p(exp(x)) on [0, 7.5] (LOOKUP_FLOAT)."""
    c = _consts(x.device)
    k = c["lc"][torch.bucketize(x, c["lb"])]
    return ((k[..., 0] * x + k[..., 1]) * x + k[..., 2]) * x + k[..., 3]


def log_add(x, y):
    """LOG_ADD(float, float) (ScoreType.h:269-276): approximate
    log-sum-exp with exact LOG_ZERO absorption and the 7.5 underflow
    threshold.  log_add(v, LOG_ZERO) == v exactly."""
    hi = torch.maximum(x, y)
    lo = torch.minimum(x, y)
    d = hi - lo
    return torch.where((lo == LOG_ZERO) | (d >= THR), hi,
                       lookup_float(d) + lo)


def exp_ref(x):
    """Branch-polynomial EXP (ScoreType.h:40-60); exp(x) for x > 0,
    0 below -16."""
    c = _consts(x.device)
    piece = torch.bucketize(x, c["eb"])
    k = c["ec"][piece]
    p = (((k[..., 0] * x + k[..., 1]) * x + k[..., 2]) * x
         + k[..., 3]) * x + k[..., 4]
    p = torch.where(piece == 0, 0.0, p)
    return torch.where(piece == len(_EXP_BOUNDS), torch.exp(x), p)


def _setup(xp, yp, lmatch, lins):
    """Gather tables and feeds shared by both directions.

    xfeed[:, 2Lp+1-d : 2Lp+1-d+W] is diagonal d's x row with the JAX
    package's clipped index: lane j holds x_{d-j}, PAD for d-j <= 0 and
    x_Lp for d-j > Lp.  Tables get a 22nd class, LOG_ZERO everywhere,
    which the backward pass reads past the last lane (its shift fills
    LOG_ZERO there).
    """
    B, Lp = xp.shape
    dev = xp.device
    xl, yl = xp.long(), yp.long()
    pad = torch.full((B, Lp + 1), PAD, dtype=torch.long, device=dev)
    xfeed = torch.cat([xl[:, -1:].expand(B, Lp + 1), xl.flip(1), pad], 1)
    yg = torch.cat([pad[:, :1], yl], 1)                        # y_j, j=0..Lp
    ynext = torch.cat([yl, torch.full((B, 1), OFF, dtype=torch.long,
                                      device=dev)], 1)       # y_{j+1}
    lm, li = class_tables(lmatch, lins)
    return xfeed, xfeed * NCLS, yg, ynext, lm, li


def class_tables(lmatch, lins):
    """(lm (NCLS * NCLS,), li (2, NCLS)) f32: the match and insert log
    tables with the 22nd, all-LOG_ZERO class."""
    dev = lmatch.device
    lm = torch.full((NCLS, NCLS), LOG_ZERO, dtype=torch.float32, device=dev)
    lm[:21, :21] = lmatch
    li = torch.full((2, NCLS), LOG_ZERO, dtype=torch.float32, device=dev)
    li[:, :21] = lins.T
    return lm.reshape(-1), li


def hmm5_fb_qpx(xp, yp, lx, ly, init, trans, lmatch, lins):
    """Forward+backward match planes and total, reference arithmetic.

    xp/yp: (B, Lp) int8 classes (PAD padding); lx/ly true lengths.
    init/trans: log f32 (5,), (5, 5); lmatch (21, 21); lins (21, 2).
    Returns (fwd_m (D, B, W), bwd_m (D, B, W), total (B,)) with
    total = (totalF + totalB) / 2 (PosteriorStage.cpp:141).  The planes
    are views of padded buffers (one spare lane, two spare rows): the
    states of the other four kinds are kept only as the recurrences and
    the totals need them.
    """
    B, Lp = xp.shape
    W, D = Lp + 1, 2 * Lp + 1
    dev = xp.device
    t, i5 = trans, init
    lxv = lx.to(torch.int64)[:, None]
    lyv = ly.to(torch.int64)[:, None]
    dterm = (lx.to(torch.int64) + ly.to(torch.int64))
    xfeed, xfeed22, yg, ynext, lm, li = _setup(xp, yp, lmatch, lins)
    lane = torch.arange(W, device=dev)[None, :]                  # (1, W)
    irow = torch.arange(D, device=dev)[:, None, None] - lane     # (D, 1, W)
    at_term = (dterm[None, :] == torch.arange(D, device=dev)[:, None])
    lane_ly = lane == lyv                                        # (B, W)
    bidx = torch.arange(B, device=dev)
    lz = torch.tensor(LOG_ZERO, device=dev)  # out= takes no scalar

    def xrow(d, table):
        s = 2 * Lp + 1 - d
        return table[:, s:s + W]

    def vec(*vals):
        return torch.stack(list(vals)).reshape(-1, 1, 1)

    # stacked insert states: order x1, x2, y1, y2 (x consume sequence x)
    is_x = torch.tensor([True, True, False, False], device=dev)[:, None,
                                                                None]

    # ---------------- forward ----------------
    # fwd_mp row d+2 holds diagonal d; lane 0 is the shift's LOG_ZERO fill
    fwd_mp = torch.full((D + 2, B, W + 1), LOG_ZERO, dtype=torch.float32,
                        device=dev)
    fwd_m = fwd_mp[2:, :, 1:]
    ring = [torch.full((4, B, W + 1), LOG_ZERO, dtype=torch.float32,
                       device=dev) for _ in range(3)]
    insy = li[:, yg]                                             # (2, B, W)
    tk0 = vec(t[1, 0], t[3, 0], t[2, 0], t[4, 0])
    t0q = vec(t[0, 1], t[0, 3], t[0, 2], t[0, 4])
    tqq = vec(t[1, 1], t[3, 3], t[2, 2], t[4, 4])
    i5q = vec(i5[1], i5[3], i5[2], i5[4])
    mask_m = (irow >= 1) & (lane >= 1)
    mask_ins = torch.where(is_x[None], (irow >= 1)[:, None],
                           ((lane >= 1) & (irow >= 0))[:, None])
    init_lane = torch.where(is_x, lane == 0, lane == 1)          # (4, 1, W)
    term_ins = torch.full((4, B, 1), LOG_ZERO, dtype=torch.float32,
                          device=dev)
    ly_idx = lyv[None].expand(4, B, 1)
    for d in range(D):
        xr = xrow(d, xfeed)
        em = lm[xrow(d, xfeed22) + yg]
        s1 = ring[(d - 1) % 3]
        p2m = fwd_mp[d][:, :-1]
        p2 = ring[(d - 2) % 3][:, :, :-1]
        # match: the LPE chain over the five d-2 states at lane j-1
        # (ParallelProbabilisticModel.cpp:91-96), order X1 Y1 X2 Y2
        acc = p2m + t[0, 0]
        acc = torch.where(acc > HALF_LOG_ZERO, acc, LOG_ZERO)
        terms = torch.where(p2 == LOG_ZERO, LOG_ZERO, p2 + tk0)
        for k in (0, 2, 1, 3):
            acc = log_add(acc, terms[k])
        m_new = acc + em
        if d == 2:   # init cell (1, 1): preset, recurrence skipped
            m_new = torch.where(lane == 1, i5[0] + em, m_new)
        torch.where(mask_m[d], m_new, lz, out=fwd_mp[d + 2][:, 1:])
        # inserts: x from (i-1, j) at d-1, same lane; y from (i, j-1) at
        # d-1, lane j-1
        pm1 = fwd_mp[d + 1]
        pm = torch.cat([pm1[None, :, 1:].expand(2, B, W),
                        pm1[None, :, :-1].expand(2, B, W)])
        ps = torch.cat([s1[0:2, :, 1:], s1[2:4, :, :-1]])
        a = torch.where(pm == LOG_ZERO, LOG_ZERO, pm + t0q)
        b = torch.where(ps == LOG_ZERO, LOG_ZERO, ps + tqq)
        ins = torch.cat([li[:, xr], insy])
        v = ins + log_add(a, b)
        if d == 1:
            v = torch.where(init_lane, i5q + ins, v)
        new = ring[d % 3]
        torch.where(mask_ins[d], v, lz, out=new[:, :, 1:])
        term_ins = torch.where(at_term[d][None, :, None],
                               new[:, :, 1:].gather(2, ly_idx), term_ins)

    # total at (lx, ly): LPE order M, X1, Y1, X2, Y2
    # (ParallelProbabilisticModel.cpp:124-130); a lane sum of one value
    # and zeros in the JAX package, one gather here
    picks = (fwd_m[dterm, bidx, ly.to(torch.int64)], term_ins[0, :, 0],
             term_ins[2, :, 0], term_ins[1, :, 0], term_ins[3, :, 0])
    total_f = torch.full((B,), LOG_ZERO, dtype=torch.float32, device=dev)
    for k, v in enumerate(picks):
        total_f = log_add(total_f, torch.where(v == 0.0, LOG_ZERO,
                                               v + i5[k]))

    # ---------------- backward ----------------
    # bwd_mp row d holds diagonal d (rows D, D+1 stay LOG_ZERO); the last
    # lane is the shift's LOG_ZERO fill
    bwd_mp = torch.full((D + 2, B, W + 1), LOG_ZERO, dtype=torch.float32,
                        device=dev)
    bwd_m = bwd_mp[:D, :, :W]
    bring = [torch.full((4, B, W + 1), LOG_ZERO, dtype=torch.float32,
                        device=dev) for _ in range(2)]
    insy_next = li[:, ynext]                                     # (2, B, W)
    zrow = torch.full((B, W), LOG_ZERO, dtype=torch.float32, device=dev)
    zrow2 = torch.full((2, B, W), LOG_ZERO, dtype=torch.float32, device=dev)
    tb4 = vec(t[0, 1], t[0, 3], t[0, 2], t[0, 4])
    te4 = vec(t[1, 1], t[3, 3], t[2, 2], t[4, 4])
    pt4 = vec(t[1, 0], t[3, 0], t[2, 0], t[4, 0])
    i5b = vec(i5[1], i5[3], i5[2], i5[4])
    mask_j = lane < lyv
    valid_j = lane <= lyv
    ins_d1 = None
    for d in range(D - 1, -1, -1):
        # next chars: c1 = x_{i+1} (diagonal d+1's x row), c2 = y_{j+1}
        if d <= D - 3:
            em_n = lm[xrow(d + 1, xfeed22) + ynext]
        else:
            em_n = zrow
        ixn = li[:, xrow(d + 1, xfeed)] if d <= D - 2 else zrow2
        mask_i = irow[d] < lxv
        valid = (irow[d] >= 0) & (irow[d] <= lxv) & valid_j
        mm = mask_i & mask_j
        # ProbXY = b[i+1, j+1] + matchProb(c1, c2): d+2, lane j+1
        n2m = bwd_mp[d + 2][:, 1:]
        pxy = torch.where(n2m == LOG_ZERO, LOG_ZERO, n2m + em_n)
        pxy_ok = mm & (pxy != LOG_ZERO)
        acc = torch.where(pxy_ok, pxy + t[0, 0], LOG_ZERO)
        s1 = bring[(d + 1) % 2]
        s4 = torch.cat([s1[0:2, :, :W], s1[2:4, :, 1:]])
        se = s4 + torch.cat([ixn, insy_next])
        ok4 = torch.where(is_x, mask_i, mask_j) & (s4 != LOG_ZERO)
        # order into b: M, X1, X2, Y1, Y2
        # (ParallelProbabilisticModel.cpp:198-218)
        tb = torch.where(ok4, se + tb4, LOG_ZERO)
        for k in range(4):
            acc = log_add(acc, tb[k])
        # insert-state levels
        lvl = torch.where(pxy_ok, pxy + pt4, LOG_ZERO)
        ins_new = log_add(lvl, torch.where(ok4, se + te4, LOG_ZERO))
        # terminal cell (lx, ly): initial distribution
        at_cell = at_term[d][:, None] & lane_ly
        acc = torch.where(at_cell, i5[0], acc)
        ins_new = torch.where(at_cell, i5b, ins_new)
        torch.where(valid, acc, lz, out=bwd_mp[d][:, :W])
        new = bring[d % 2]
        torch.where(valid, ins_new, lz, out=new[:, :, :W])
        if d == 1:
            ins_d1 = new[:, :, :W].clone()

    # backward total (ParallelProbabilisticModel.cpp:228-233):
    # total = init0 + matchProb(x1, y1) + b[1,1]; then the k loop X1, Y1,
    # X2, Y2 with the (1,0)/(0,1) insert levels
    x1c, y1c = xp[:, 0].long(), yp[:, 0].long()
    total_b = i5[0] + lm[x1c * NCLS + y1c] + bwd_m[2][:, 1]
    for kinit, ins, row, lanei in (
        (1, li[0, x1c], ins_d1[0], 0),
        (2, li[0, y1c], ins_d1[2], 1),
        (3, li[1, x1c], ins_d1[1], 0),
        (4, li[1, y1c], ins_d1[3], 1),
    ):
        total_b = log_add(total_b, i5[kinit] + ins + row[:, lanei])

    total = (total_f + total_b) * 0.5
    return fwd_m, bwd_m, total


def hmm5_posterior_qpx(xp, yp, lx, ly, init, trans, lmatch, lins):
    """(D, B, W) match posterior with reference arithmetic:
    `posterior_from_fb` of `hmm5_fb_qpx`."""
    fwd_m, bwd_m, total = hmm5_fb_qpx(xp, yp, lx, ly, init, trans,
                                      lmatch, lins)
    return posterior_from_fb(fwd_m, bwd_m, total, lx, ly)


def posterior_from_fb(fwd_m, bwd_m, total, lx, ly):
    """(D, B, W) match posterior from the forward/backward match planes
    and totals: p = EXP(min(0, f + b - total)), p[0, j] = p[i, 0] = 0,
    zero outside each pair's (lx+1) x (ly+1) grid.  Written over the
    forward plane, `_POST_CHUNK` diagonals at a time, so the pass holds no
    more than the two planes; the qpx kernels' planes
    (ops/kernels/qpx_kernel.py) take the same pass."""
    D, B, W = fwd_m.shape
    dev = fwd_m.device
    tot = torch.where(total == 0.0, 1.0, total)[None, :, None]
    zero = torch.zeros((), device=dev)
    lane = torch.arange(W, device=dev)[None, None, :]
    lxv = lx.to(torch.int64)[None, :, None]
    lyv = ly.to(torch.int64)[None, :, None]
    for d0 in range(0, D, _POST_CHUNK):
        d1 = min(D, d0 + _POST_CHUNK)
        i_idx = torch.arange(d0, d1, device=dev)[:, None, None] - lane
        x = fwd_m[d0:d1] + bwd_m[d0:d1]
        x = torch.clamp(x - tot, max=0.0)
        inside = (i_idx >= 1) & (lane >= 1) & (i_idx <= lxv) & (lane <= lyv)
        torch.where(inside, exp_ref(x), zero, out=fwd_m[d0:d1])
    return fwd_m


def _shift1(v):
    """lane j -> value at lane j-1, LOG_ZERO into lane 0."""
    return torch.cat([torch.full_like(v[..., :1], LOG_ZERO), v[..., :-1]],
                     dim=-1)


def _shiftm1(v):
    """lane j -> value at lane j+1, LOG_ZERO into the last lane."""
    return torch.cat([v[..., 1:], torch.full_like(v[..., :1], LOG_ZERO)],
                     dim=-1)


def _guard(v, a, b=None):
    """(v + a) - b, or LOG_ZERO where v is LOG_ZERO (the reference's
    guard on a term from an unreached state)."""
    r = v + a if b is None else v + a - b
    return torch.where(v == LOG_ZERO, LOG_ZERO, r)


def local_posterior_qpx(xp, yp, lx, ly, ltrans, log_stay, lmatch, lins):
    """baseMSA 3-state local-HMM posterior, reference arithmetic.

    The local model runs in ODDS space: every term carries
    -insProb(x)-insProb(y) and -2*random_transProb[1] factors
    (ProbabilisticModel.h:213-258 flag=false branches); flanking random
    states let the alignment start/end anywhere, so the total
    accumulates over ALL (i>0, j>0) cells (ibid:420-434).  As in the JAX
    package, the totals are an exact stable log-sum-exp instead of the
    reference's row-major LOG_PLUS_EQUALS chain; every recurrence keeps
    the reference's LOG_ADD order and guards, one Python step a
    diagonal where the JAX package runs a `lax.scan`.

    xp/yp (B, Lp) classes; ltrans: (3, 3) log local transitions;
    log_stay = log(1 - leave) (= random_transProb[1]); lmatch (21, 21);
    lins (21,).  Returns the (D, B, W) posterior.
    """
    B, Lp = xp.shape
    W, D = Lp + 1, 2 * Lp + 1
    dev = xp.device
    lane = torch.arange(W, device=dev)[None, :]
    lxv = lx.to(torch.int64)[:, None]
    lyv = ly.to(torch.int64)[:, None]
    Z = torch.full((B, W), LOG_ZERO, dtype=torch.float32, device=dev)
    rt1 = torch.as_tensor(log_stay, dtype=torch.float32, device=dev)
    t = ltrans

    # em'[d, b, j] = lmatch[x_i, y_j] - lins[x_i] - lins[y_j] - 2*rt1
    pad = torch.full((B, 1), PAD, dtype=torch.long, device=dev)
    xg = torch.cat([pad, xp.long()], dim=1)
    yg = torch.cat([pad, yp.long()], dim=1)
    d_idx = torch.arange(D, device=dev)[:, None]
    i_idx = torch.clamp(d_idx - lane, 0, Lp)
    xsk = xg[:, i_idx]                                   # (B, D, W)
    em = (lmatch[xsk, yg[:, None, :]] - lins[xsk]
          - lins[yg][:, None, :] - 2.0 * rt1)
    em = em.movedim(0, 1).contiguous()                   # (D, B, W)
    del xsk

    fwd_m = torch.empty((D, B, W), dtype=torch.float32, device=dev)
    p1 = p2 = (Z, Z, Z)
    for d in range(D):
        emr = em[d]
        i = d - lane
        # match: acc = em'; then LPE over the three d-2 states
        acc = emr
        for k in range(3):
            prev = _shift1(p2[k])
            acc = log_add(acc, torch.where(prev == LOG_ZERO, LOG_ZERO,
                                           emr + prev + t[k, 0]))
        m_new = torch.where((i >= 1) & (lane >= 1), acc, LOG_ZERO)
        # X: (i-1, j) at d-1 same lane
        x_new = log_add(_guard(p1[0], t[0, 1], rt1),
                        _guard(p1[1], t[1, 1], rt1))
        x_new = torch.where(i >= 1, x_new, LOG_ZERO)
        # Y: (i, j-1) at d-1 lane j-1
        y_new = log_add(_guard(_shift1(p1[0]), t[0, 2], rt1),
                        _guard(_shift1(p1[2]), t[2, 2], rt1))
        y_new = torch.where((lane >= 1) & (i >= 0), y_new, LOG_ZERO)
        p1, p2 = (m_new, x_new, y_new), p1
        fwd_m[d] = m_new

    # backward: em' of the NEXT cell (i+1, j+1) = em[d+2] shifted -1
    bwd_m = torch.empty((D, B, W), dtype=torch.float32, device=dev)
    mask_j = lane < lyv
    n1 = n2 = (Z, Z, Z)
    for d in range(D - 1, -1, -1):
        em_n = _shiftm1(em[d + 2]) if d + 2 < D else Z
        i = d - lane
        mask_i = i < lxv
        valid = (i >= 0) & (i <= lxv) & (lane <= lyv)
        pxy = _guard(_shiftm1(n2[0]), em_n)
        mm = mask_i & mask_j
        s2 = _shiftm1(n1[2])
        # b0 starts at LOG_ONE everywhere (the alignment may end at any
        # cell, ProbabilisticModel.h:339); order M, X, Y
        b0 = torch.zeros_like(Z)
        b0 = log_add(b0, torch.where(mm, _guard(pxy, t[0, 0]), LOG_ZERO))
        b0 = log_add(b0, torch.where(mask_i, _guard(n1[1], t[0, 1], rt1),
                                     LOG_ZERO))
        b0 = log_add(b0, torch.where(mask_j, _guard(s2, t[0, 2], rt1),
                                     LOG_ZERO))
        bx = log_add(
            torch.where(mm, _guard(pxy, t[1, 0]), LOG_ZERO),
            torch.where(mask_i, _guard(n1[1], t[1, 1], rt1), LOG_ZERO),
        )
        by = log_add(
            torch.where(mm, _guard(pxy, t[2, 0]), LOG_ZERO),
            torch.where(mask_j, _guard(s2, t[2, 2], rt1), LOG_ZERO),
        )
        b0 = torch.where(valid, b0, LOG_ZERO)
        n1, n2 = (b0, torch.where(valid, bx, LOG_ZERO),
                  torch.where(valid, by, LOG_ZERO)), n1
        bwd_m[d] = b0

    # totals over all interior cells (exact stable LSE; see docstring)
    i3 = torch.arange(D, device=dev)[:, None, None] - lane[None]
    interior = ((i3 >= 1) & (lane[None] >= 1)
                & (i3 <= lxv[None]) & (lane[None] <= lyv[None]))

    def lse(plane):
        mx = torch.where(interior, plane, -torch.inf).amax(dim=(0, 2))
        s = torch.where(interior, torch.exp(plane - mx[None, :, None]),
                        0.0).sum(dim=(0, 2))
        return mx + torch.log(s)

    total_f = lse(fwd_m)
    total_b = lse(bwd_m + em)
    del em
    total = (total_f + total_b) * 0.5

    tot = torch.where(total == 0.0, 1.0, total)[None, :, None]
    fwd_m.add_(bwd_m).sub_(tot).clamp_(max=0.0)
    del bwd_m
    return torch.where(interior, exp_ref(fwd_m), 0.0)
