"""Wrappers of the two CUDA kernels of the posterior stage.

`sweep` and `combine` replace the Pallas TPU kernels of the same names
(mlprobs_tpu/ops/pallas/wavefront_kernel.py); `posterior` chains them as
`posterior_pallas` does: a reversed sweep that emits pre-emission planes,
a forward sweep, then combine.  The contract is the plain wavefront
engine's (ops/wavefront.py), not the TPU's layout: skewed planes of
D = 2*Lp + 1 rows and W = Lp + 1 lanes, per-diagonal scales as separate
(D, B) tensors, exact zeros beyond the true extents.

`mwt_topk` runs combine's MWT and top-k over a posterior plane that the
caller already holds (the kernel's GIVEN kind): the realigner's qp route,
whose plane comes from the qpx kernels and the partition posterior.

Each wrapper runs its plain PyTorch version (`sweep_reference`,
`combine_reference`, `mwt_topk_reference`) only when its input lies on
the CPU.  For any other tensor it launches the kernel on the current
stream or raises: a build or launch failure is never answered by the
plain version.  An argument the
kernel does not take raises KernelArgumentError, a fault of the caller
that no stage of the pipeline keeps a block for.  `sweep.launches` and
`combine.launches` count the kernel launches (`mwt_topk`'s among
combine's).

`sweep_plan` and `combine_plan` compute each kernel's launch plan (which
instance, blocks a pair, threads, lanes a thread, ring rows, shared
bytes); the wrapper passes it to the launch, and the launcher checks it
against its own shared-memory layout.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mlprobs_tpu_torch.ops import wavefront as wf
from mlprobs_tpu_torch.ops.kernels import build, qpx_kernel, viterbi_kernel
from mlprobs_tpu_torch.ops.kernels.build import KernelArgumentError, check_arg

MODEL_KIND = {"hmm5": 0, "local": 1, "partition": 2}
GIVEN = 3   # csrc/combine.cu: a given posterior plane, the only model
# per-model packed table layout, in floats (csrc/sweep.cu TAB_*)
TAB_SIZE = 544
_TAB_PINS, _TAB_T, _TAB_INIT = 448, 496, 528
_TAB_C1, _TAB_C2, _TAB_GO, _TAB_GE = 536, 537, 538, 539

sweep_reference = wf.wavefront_forward

# The H100's shared memory (bytes): a block's most, an SM's, and what the
# card keeps of it for each block
SMEM_BLOCK_MAX = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
MAX_CLUSTER = 16          # blocks a cluster (non-portable on the H100)
SWEEP_MAX_LP = 49152      # the most lanes each kernel takes
COMBINE_MAX_LP = 65536

# sweep: the short instance (4 lanes a thread, blocks of up to 256
# threads, clusters of up to 8) up to SWEEP_LONG_FROM - 1 lanes; past it
# the long instance's tiers, (lanes a thread, threads a block at most),
# each in clusters of up to 16 blocks
SWEEP_LONG_FROM = 8193
_SWEEP_LONG_TIERS = ((4, 256), (8, 256), (8, 384))


class SweepPlan(NamedTuple):
    instance: int   # 0 short, 1 long
    lpt: int        # lanes a thread
    maxt: int       # threads a block at most (the instance's bound)
    blocks: int     # blocks a (pair, model), one cluster when > 1
    threads: int    # threads a block
    smem: int       # dynamic shared bytes a block

    @property
    def span(self) -> int:
        """Lanes a block: block r owns lanes 1 + r * span onwards."""
        return self.threads * self.lpt


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _sweep_smem(lp, lpt, maxt, long, blocks, threads) -> int:
    # csrc/sweep.cu smem_layout, in floats, then the x row in bytes
    nw = threads // 32
    r = blocks * nw
    red = 496
    edge = red + 2 * (256 if long else 64)
    ring_rs = edge + 2 * (maxt // 32) * 8
    ring_fs = ring_rs + 64 * r
    stage = (ring_fs + 2 * 64 + 3) // 4 * 4
    xs = stage + nw * 32 * lpt
    xrow = ((lp + 15) // 16 * 16 if long
            else 3 * lp + 2 + blocks * threads * lpt + 16)
    return xs * 4 + xrow


def sweep_plan(lp: int) -> SweepPlan:
    """The sweep kernel's launch for Lp = lp: lanes 1..lp split over
    `blocks` blocks of `threads` threads, `lpt` contiguous lanes each."""
    if not 0 <= lp <= SWEEP_MAX_LP:
        raise KernelArgumentError(f"Lp {lp} outside [0, {SWEEP_MAX_LP}]")
    if lp < SWEEP_LONG_FROM:
        inst, lpt, maxt = 0, 4, 256
    else:
        inst = 1
        lpt, maxt = next(t for t in _SWEEP_LONG_TIERS
                         if lp <= MAX_CLUSTER * t[0] * t[1])
    blocks = max(1, _ceil_div(lp, maxt * lpt))
    threads = max(32, _ceil_div(_ceil_div(_ceil_div(lp, blocks), lpt), 32)
                  * 32)
    return SweepPlan(inst, lpt, maxt, blocks, threads,
                     _sweep_smem(lp, lpt, maxt, inst == 1, blocks, threads))


# combine: one block a pair, 16 lanes a thread, up to COMBINE_CLUSTER_FROM
# - 1 lanes; past it a cluster a pair at the lanes a thread of the first
# tier that holds Lp in 16 blocks of 8 DP warps
COMBINE_CLUSTER_FROM = 4097
_COMBINE_CLUSTER_LPT = (4, 8, 16)
_MAX_DP_WARPS, _MAX_PRODUCERS, _MAX_RING, _XE = 8, 8, 16, 32


class CombinePlan(NamedTuple):
    instance: int   # 0 one block a pair, 1 a cluster a pair
    lpt: int        # the DP's lanes a thread
    dp_warps: int   # DP warps a block
    producers: int  # producer warps a block
    rows: int       # ring rows a block
    blocks: int     # blocks a pair
    smem: int       # dynamic shared bytes a block
    list_len: int   # (cluster, top-k) entries of a block's top-k list

    @property
    def span(self) -> int:
        """DP lanes a block: block r owns lanes 1 + r * span onwards."""
        return self.dp_warps * 32 * self.lpt


def _combine_smem(g, lpt, rows, cluster) -> int:
    # csrc/combine.cu smem_bytes
    return (rows * (g * 32 * lpt + 4) * 4 + 2 * rows * 8
            + 2 * _MAX_DP_WARPS * 8 + 2 * _MAX_PRODUCERS * 32 * 4
            + (_XE * 8 + 16 if cluster else 0))


def combine_plan(lp: int, topk: int = 0) -> CombinePlan:
    """The combine kernel's launch for Lp = lp (and `topk`, the length
    of each block's list in a cluster)."""
    if not 0 <= lp <= COMBINE_MAX_LP:
        raise KernelArgumentError(f"Lp {lp} outside [0, {COMBINE_MAX_LP}]")

    def depth(g, lpt, cluster, budget, least):
        # the most ring rows, at most _MAX_RING, within budget; least
        # whatever the budget
        fixed = _combine_smem(g, lpt, 0, cluster)
        per_row = _combine_smem(g, lpt, 1, cluster) - fixed
        return max(least, min(_MAX_RING, (budget - fixed) // per_row))

    if lp < COMBINE_CLUSTER_FROM:
        lpt, blocks = 16, 1
        g = max(1, _ceil_div(lp, 32 * lpt))
        # the ring's depth: two blocks an SM where they fit, else one
        half = SMEM_PER_SM // 2 - SMEM_RESERVED
        rows = depth(g, lpt, False, half, 2)
        if _combine_smem(g, lpt, rows, False) > half:
            rows = depth(g, lpt, False, SMEM_BLOCK_MAX, 2)
        # no more producers than ring rows
        prod = min(_MAX_PRODUCERS - 1 if g == 1 else _MAX_PRODUCERS, rows)
        return CombinePlan(0, lpt, g, prod, rows, 1,
                           _combine_smem(g, lpt, rows, False), 0)
    lpt = next(t for t in _COMBINE_CLUSTER_LPT
               if lp <= MAX_CLUSTER * _MAX_DP_WARPS * 32 * t)
    g = _ceil_div(lp, MAX_CLUSTER * 32 * lpt)
    blocks = _ceil_div(lp, g * 32 * lpt)
    rows = depth(g, lpt, True, SMEM_BLOCK_MAX, 1)
    # at 16 lanes a thread at most 384 threads a block (168 registers)
    prod = min(_MAX_PRODUCERS if lpt < 16 else 4, rows)
    kl = min(topk, g * 32 * lpt + 1)
    return CombinePlan(1, lpt, g, prod, rows, blocks,
                       _combine_smem(g, lpt, rows, True), kl)


def combine_reference(fwd, rev, lx, ly, models, with_matches=False,
                      topk=0, cutoff=0.01):
    """Plain version of `combine`: per-model posteriors, RMS, MWT and
    either the dense plane or the per-diagonal top-k."""
    if len(models) == 1:
        post = wf.posterior_skew(fwd, rev, models[0])
    else:
        acc = None
        for m in models:
            p = wf.posterior_skew(fwd, rev, m)
            acc = p * p if acc is None else acc + p * p
        post = torch.sqrt(acc / len(models))
    out = mwt_topk_reference(post, lx, ly, with_matches=with_matches,
                             topk=topk, cutoff=cutoff)
    return out if topk else (post,) + out


def mwt_topk_reference(post, lx, ly, with_matches=False, topk=0,
                       cutoff=0.01):
    """Plain version of `mwt_topk`: `topk_skew` and `mwt_skew` of the
    plane."""
    mw = wf.mwt_skew(post, lx, ly, with_matches=with_matches)
    mw = mw if with_matches else (mw,)
    head = wf.topk_skew(post, topk, cutoff) if topk else ()
    return tuple(head) + tuple(mw)


def pack_tables(tables, models, device) -> torch.Tensor:
    """(nm, TAB_SIZE) f32 table block the sweep kernel reads."""
    rows = torch.zeros((len(models), TAB_SIZE), dtype=torch.float32,
                       device=device)
    for i, m in enumerate(models):
        t = tables[m]
        rows[i, :441] = t["pm"].reshape(-1)
        if m == "hmm5":
            rows[i, _TAB_PINS:_TAB_PINS + 42] = t["pins"].reshape(-1)
            rows[i, _TAB_T:_TAB_T + 25] = t["T"].reshape(-1)
            rows[i, _TAB_INIT:_TAB_INIT + 5] = t["init"]
        elif m == "local":
            rows[i, _TAB_T:_TAB_T + 9] = t["T"].reshape(-1)
            rows[i, _TAB_C1] = t["c1"]
            rows[i, _TAB_C2] = t["c2"]
        else:
            rows[i, _TAB_GO] = t["go"]
            rows[i, _TAB_GE] = t["ge"]
    return rows


def _kinds(models):
    if not 1 <= len(models) <= 3 or not set(models) <= set(MODEL_KIND):
        raise KernelArgumentError(f"1 to 3 models of {sorted(MODEL_KIND)}, "
                                  f"got {models}")
    return [MODEL_KIND[m] for m in models] + [0] * (3 - len(models))


def sweep(X, Y, ox, oy, lx, ly, tables, models=("hmm5",), emit_pre=False):
    """One wavefront pass of every model in `models`, one launch.

    X/Y (B, Lp) int8, ox/oy/lx/ly (B,) int32.  Returns the plain
    engine's dict {"planes", "scales", "log2t"} (model -> tensor); on the
    card it also carries "stacked", the (nm, D, B, W) planes, (nm, D, B)
    scales and (nm, B) totals those entries are views of.
    """
    if X.device.type == "cpu":
        return sweep_reference(X, Y, ox, oy, lx, ly, tables, models=models,
                               emit_pre=emit_pre)
    lib = build.lib("sweep")
    dev = X.device
    B, Lp = X.shape
    D, W, nm = 2 * Lp + 1, Lp + 1, len(models)
    kinds = _kinds(models)
    check_arg("X", X, torch.int8, (B, Lp), dev)
    check_arg("Y", Y, torch.int8, (B, Lp), dev)
    for nme, t in (("ox", ox), ("oy", oy), ("lx", lx), ("ly", ly)):
        check_arg(nme, t, torch.int32, (B,), dev)
    plan = sweep_plan(Lp)
    tabs = pack_tables(tables, models, dev)
    planes = torch.empty((nm, D, B, W), dtype=torch.float32, device=dev)
    scales = torch.empty((nm, D, B), dtype=torch.float32, device=dev)
    l2t = torch.empty((nm, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sweep_launch(
            X.data_ptr(), Y.data_ptr(), ox.data_ptr(), oy.data_ptr(),
            lx.data_ptr(), ly.data_ptr(), tabs.data_ptr(), nm, *kinds, B,
            Lp, int(bool(emit_pre)), *plan, planes.data_ptr(),
            scales.data_ptr(), l2t.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"sweep kernel launch failed: CUDA error {err}")
    sweep.launches += 1
    return {
        "planes": {m: planes[i] for i, m in enumerate(models)},
        "scales": {m: scales[i] for i, m in enumerate(models)},
        "log2t": {m: l2t[i] for i, m in enumerate(models)},
        "stacked": (planes, scales, l2t),
    }


sweep.launches = 0


def _topk_lists(plan, D, B, dev, topk):
    """(values, lanes, lengths) of the cluster's per-block top-k lists,
    or three Nones where the plan keeps none."""
    if not (topk and plan.blocks > 1):
        return None, None, None
    shape = (D, B, plan.blocks, plan.list_len)
    return (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev),
            torch.empty(shape[:3], dtype=torch.int32, device=dev))


def _stacked(res, models):
    if "stacked" in res and res["stacked"][0].shape[0] == len(models):
        return res["stacked"]
    return tuple(
        torch.stack([res[k][m] for m in models]).contiguous()
        for k in ("planes", "scales", "log2t")
    )


def combine(fwd, rev, lx, ly, models=("hmm5",), with_matches=False,
            topk=0, cutoff=0.01):
    """Posterior combine + MWT over the sweep outputs, one launch.

    topk == 0: returns (post (D, B, W), score (B,)[, nb (B,)]).
    topk > 0: returns (vals (D, B, topk), lanes (D, B, topk) int32,
    score[, nb]); the posterior plane never reaches device memory.
    """
    if lx.device.type == "cpu":
        return combine_reference(fwd, rev, lx, ly, models,
                                 with_matches=with_matches, topk=topk,
                                 cutoff=cutoff)
    lib = build.lib("combine")
    dev = lx.device
    fp, fs, fl = _stacked(fwd, models)
    rp, rs, rl = _stacked(rev, models)
    nm, D, B, W = fp.shape
    Lp = W - 1
    kinds = _kinds(models)
    for nme, t in (("fwd planes", fp), ("rev planes", rp)):
        check_arg(nme, t, torch.float32, (len(models), 2 * Lp + 1, B, W),
                  dev)
    for nme, t in (("fwd scales", fs), ("rev scales", rs)):
        check_arg(nme, t, torch.float32, (nm, D, B), dev)
    for nme, t in (("fwd totals", fl), ("rev totals", rl)):
        check_arg(nme, t, torch.float32, (nm, B), dev)
    check_arg("lx", lx, torch.int32, (B,), dev)
    check_arg("ly", ly, torch.int32, (B,), dev)
    if not 0 <= topk <= W:
        raise KernelArgumentError(f"topk {topk} outside [0, {W}]")
    plan = combine_plan(Lp, topk)
    lists = _topk_lists(plan, D, B, dev, topk)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    nb = torch.empty((B,), dtype=torch.float32, device=dev)
    if topk:
        post = None
        vals = torch.empty((D, B, topk), dtype=torch.float32, device=dev)
        lanes = torch.empty((D, B, topk), dtype=torch.int32, device=dev)
    else:
        post = torch.empty((D, B, W), dtype=torch.float32, device=dev)
        vals = lanes = None
    ptr = (lambda t: 0 if t is None else t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.combine_launch(
            fp.data_ptr(), fs.data_ptr(), fl.data_ptr(), rp.data_ptr(),
            rs.data_ptr(), rl.data_ptr(), lx.data_ptr(), ly.data_ptr(),
            nm, *kinds, B, Lp, int(bool(with_matches)), int(topk),
            float(cutoff), ptr(post), ptr(vals), ptr(lanes),
            score.data_ptr(), nb.data_ptr(), *plan,
            *(ptr(t) for t in lists), stream,
        )
    if err != 0:
        raise RuntimeError(f"combine kernel launch failed: CUDA error {err}")
    combine.launches += 1
    head = (vals, lanes) if topk else (post,)
    return head + ((score, nb) if with_matches else (score,))


combine.launches = 0


def mwt_topk(post, lx, ly, with_matches=False, topk=0, cutoff=0.01):
    """MWT (and per-diagonal top-k) of a given (D, B, W) posterior plane,
    one launch of combine's GIVEN kind; the plane is read, not written.

    topk > 0: returns (vals (D, B, topk), lanes (D, B, topk) int32,
    score (B,)[, nb (B,)]), as `topk_skew` + `mwt_skew`, lane 0 ranked;
    topk == 0: (score[, nb]).
    """
    if post.device.type == "cpu":
        return mwt_topk_reference(post, lx, ly, with_matches=with_matches,
                                  topk=topk, cutoff=cutoff)
    lib = build.lib("combine")
    dev = post.device
    if post.dim() != 3 or post.shape[2] < 1:
        raise KernelArgumentError(f"post has shape {tuple(post.shape)}, "
                                  f"expected (2Lp + 1, B, Lp + 1)")
    _, B, W = post.shape
    Lp = W - 1
    check_arg("post", post, torch.float32, (2 * Lp + 1, B, W), dev)
    check_arg("lx", lx, torch.int32, (B,), dev)
    check_arg("ly", ly, torch.int32, (B,), dev)
    if not 0 <= topk <= W:
        raise KernelArgumentError(f"topk {topk} outside [0, {W}]")
    D = 2 * Lp + 1
    plan = combine_plan(Lp, topk)
    lists = _topk_lists(plan, D, B, dev, topk)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    nb = torch.empty((B,), dtype=torch.float32, device=dev)
    vals = lanes = None
    if topk:
        vals = torch.empty((D, B, topk), dtype=torch.float32, device=dev)
        lanes = torch.empty((D, B, topk), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.combine_launch(
            post.data_ptr(), 0, 0, 0, 0, 0, lx.data_ptr(), ly.data_ptr(),
            1, GIVEN, 0, 0, B, Lp, int(bool(with_matches)), int(topk),
            float(cutoff), 0, 0 if vals is None else vals.data_ptr(),
            0 if lanes is None else lanes.data_ptr(), score.data_ptr(),
            nb.data_ptr(), *plan,
            *(0 if t is None else t.data_ptr() for t in lists), stream,
        )
    if err != 0:
        raise RuntimeError(f"combine kernel launch failed: CUDA error {err}")
    combine.launches += 1
    head = (vals, lanes) if topk else ()
    return head + ((score, nb) if with_matches else (score,))


def sweeps(X, Y, LX, LY, tabs_f, tabs_r, models):
    """(fwd, rev): the reversed sweep (pre-emission planes, sequences
    right-aligned at offsets Lp - L) and the forward sweep of one pair
    batch, two launches."""
    b, lp = X.shape
    zero = torch.zeros((b,), dtype=torch.int32, device=X.device)
    rev = sweep(
        X.flip(1).contiguous(), Y.flip(1).contiguous(),
        (lp - LX).to(torch.int32), (lp - LY).to(torch.int32), LX, LY,
        tabs_r, models=models, emit_pre=True,
    )
    fwd = sweep(X, Y, zero, zero, LX, LY, tabs_f, models=models,
                emit_pre=False)
    return fwd, rev


def posterior(X, Y, LX, LY, tabs_f, tabs_r, models, with_matches=False,
              topk=0, cutoff=0.01):
    """The posterior stage of one pair batch: `sweeps`, then combine.
    Same outputs as `combine`."""
    fwd, rev = sweeps(X, Y, LX, LY, tabs_f, tabs_r, models)
    return combine(fwd, rev, LX, LY, models=models,
                   with_matches=with_matches, topk=topk, cutoff=cutoff)


def reset_launch_counts() -> None:
    """Set the launch counts of every kernel of the port to 0."""
    sweep.launches = 0
    combine.launches = 0
    viterbi_kernel.viterbi_stats.launches = 0
    qpx_kernel.hmm5_fb.launches = 0
