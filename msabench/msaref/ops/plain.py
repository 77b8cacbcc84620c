"""Plain versions of the port's four CUDA kernels, under the names that
`align/pairwise.py` calls (frozen from mlprobs_tpu_torch/ops/kernels/
wavefront_kernel.py, viterbi_kernel.py and qpx_kernel.py at commit
30598a0: their plain branches, which run whatever the device)."""
from __future__ import annotations

import torch

from msabench.msaref.ops import qpx
from msabench.msaref.ops import wavefront as wf


class KernelBuildError(RuntimeError):
    """Never raised here: the reference builds nothing."""


class KernelArgumentError(ValueError):
    """Never raised here: the reference has no kernel arguments."""


def combine(fwd, rev, lx, ly, models, with_matches=False, topk=0,
            cutoff=0.01):
    """Per-model posteriors, RMS, MWT and either the dense plane or the
    per-diagonal top-k (`combine_reference`)."""
    if len(models) == 1:
        post = wf.posterior_skew(fwd, rev, models[0])
    else:
        acc = None
        for m in models:
            p = wf.posterior_skew(fwd, rev, m)
            acc = p * p if acc is None else acc + p * p
        post = torch.sqrt(acc / len(models))
    out = mwt_topk(post, lx, ly, with_matches=with_matches, topk=topk,
                   cutoff=cutoff)
    return out if topk else (post,) + out


def mwt_topk(post, lx, ly, with_matches=False, topk=0, cutoff=0.01):
    """`topk_skew` and `mwt_skew` of a given plane
    (`mwt_topk_reference`)."""
    mw = wf.mwt_skew(post, lx, ly, with_matches=with_matches)
    mw = mw if with_matches else (mw,)
    head = wf.topk_skew(post, topk, cutoff) if topk else ()
    return tuple(head) + tuple(mw)


def sweeps(X, Y, LX, LY, tabs_f, tabs_r, models):
    """(fwd, rev): the reversed sweep (pre-emission planes, sequences
    right-aligned at offsets Lp - L) and the forward sweep."""
    b, lp = X.shape
    zero = torch.zeros((b,), dtype=torch.int32, device=X.device)
    rev = wf.wavefront_forward(
        X.flip(1).contiguous(), Y.flip(1).contiguous(),
        (lp - LX).to(torch.int32), (lp - LY).to(torch.int32), LX, LY,
        tabs_r, models=models, emit_pre=True,
    )
    fwd = wf.wavefront_forward(X, Y, zero, zero, LX, LY, tabs_f,
                               models=models, emit_pre=False)
    return fwd, rev


def posterior(X, Y, LX, LY, tabs_f, tabs_r, models, with_matches=False,
              topk=0, cutoff=0.01):
    """`sweeps`, then `combine`."""
    fwd, rev = sweeps(X, Y, LX, LY, tabs_f, tabs_r, models)
    return combine(fwd, rev, LX, LY, models=models,
                   with_matches=with_matches, topk=topk, cutoff=cutoff)


def viterbi_stats(xp, yp, lx, ly, p, vinit, blosum):
    """(dirs, end_state, score, pathlen, matches, scores_rev) of the
    local Viterbi and its path statistics (`viterbi_reference`)."""
    dirs, ends, score = wf.viterbi_wavefront(xp, yp, lx, ly, p, vinit)
    plen, matches, srev = wf.viterbi_path_stats(dirs, ends, xp, yp, lx, ly,
                                                blosum)
    return dirs, ends, score, plen, matches, srev


def hmm5_posterior(xp, yp, lx, ly, init, trans, lmatch, lins):
    """(D, B, W) qpx match posterior: `qpx.hmm5_fb_qpx`, then its
    posterior pass."""
    fwd_m, bwd_m, total = qpx.hmm5_fb_qpx(xp, yp, lx, ly, init, trans,
                                          lmatch, lins)
    return qpx.posterior_from_fb(fwd_m, bwd_m, total, lx, ly)
