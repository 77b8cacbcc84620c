"""Wrappers of the two CUDA kernels of the posterior stage.

`sweep` and `combine` replace the Pallas TPU kernels of the same names
(mlprobs_tpu/ops/pallas/wavefront_kernel.py); `posterior` chains them as
`posterior_pallas` does: a reversed sweep that emits pre-emission planes,
a forward sweep, then combine.  The contract is the plain wavefront
engine's (ops/wavefront.py), not the TPU's layout: skewed planes of
D = 2*Lp + 1 rows and W = Lp + 1 lanes, per-diagonal scales as separate
(D, B) tensors, exact zeros beyond the true extents.

Each wrapper runs its plain PyTorch version (`sweep_reference`,
`combine_reference`) only when its input lies on the CPU.  For any other
tensor it launches the kernel on the current stream or raises: a build or
launch failure is never answered by the plain version.  An argument the
kernel does not take raises KernelArgumentError, a fault of the caller
that no stage of the pipeline keeps a block for.  `sweep.launches` and
`combine.launches` count the kernel launches.
"""
from __future__ import annotations

import torch

from mlprobs_tpu_torch.ops import wavefront as wf
from mlprobs_tpu_torch.ops.kernels import build

MODEL_KIND = {"hmm5": 0, "local": 1, "partition": 2}
# per-model packed table layout, in floats (csrc/sweep.cu TAB_*)
TAB_SIZE = 544
_TAB_PINS, _TAB_T, _TAB_INIT = 448, 496, 528
_TAB_C1, _TAB_C2, _TAB_GO, _TAB_GE = 536, 537, 538, 539

sweep_reference = wf.wavefront_forward


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
    mw = wf.mwt_skew(post, lx, ly, with_matches=with_matches)
    mw = mw if with_matches else (mw,)
    if topk:
        return wf.topk_skew(post, topk, cutoff) + tuple(mw)
    return (post,) + tuple(mw)


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


class KernelArgumentError(RuntimeError):
    """A wrapper was given a tensor or an option its kernel does not take:
    a fault of the program, never of the family being aligned."""


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise KernelArgumentError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise KernelArgumentError(f"{name} has dtype {t.dtype}, "
                                  f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise KernelArgumentError(f"{name} has shape {tuple(t.shape)}, "
                                  f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise KernelArgumentError(f"{name} is not contiguous")


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
    _check("X", X, torch.int8, (B, Lp), dev)
    _check("Y", Y, torch.int8, (B, Lp), dev)
    for nme, t in (("ox", ox), ("oy", oy), ("lx", lx), ("ly", ly)):
        _check(nme, t, torch.int32, (B,), dev)
    tabs = pack_tables(tables, models, dev)
    planes = torch.empty((nm, D, B, W), dtype=torch.float32, device=dev)
    scales = torch.empty((nm, D, B), dtype=torch.float32, device=dev)
    l2t = torch.empty((nm, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sweep_launch(
            X.data_ptr(), Y.data_ptr(), ox.data_ptr(), oy.data_ptr(),
            lx.data_ptr(), ly.data_ptr(), tabs.data_ptr(), nm, *kinds, B,
            Lp, int(bool(emit_pre)), planes.data_ptr(), scales.data_ptr(),
            l2t.data_ptr(), stream,
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
        _check(nme, t, torch.float32, (len(models), 2 * Lp + 1, B, W), dev)
    for nme, t in (("fwd scales", fs), ("rev scales", rs)):
        _check(nme, t, torch.float32, (nm, D, B), dev)
    for nme, t in (("fwd totals", fl), ("rev totals", rl)):
        _check(nme, t, torch.float32, (nm, B), dev)
    _check("lx", lx, torch.int32, (B,), dev)
    _check("ly", ly, torch.int32, (B,), dev)
    if not 0 <= topk <= W:
        raise KernelArgumentError(f"topk {topk} outside [0, {W}]")
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
            score.data_ptr(), nb.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"combine kernel launch failed: CUDA error {err}")
    combine.launches += 1
    head = (vals, lanes) if topk else (post,)
    return head + ((score, nb) if with_matches else (score,))


combine.launches = 0


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
    sweep.launches = 0
    combine.launches = 0
