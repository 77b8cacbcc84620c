"""Wrapper of the feature pass's CUDA kernel (csrc/viterbi.cu).

`viterbi_stats` computes what `wavefront.viterbi_wavefront` followed by
`wavefront.viterbi_path_stats` computes, in one launch: the all-pairs
local Viterbi of the feature pass and its traceback statistics.  The JAX
package runs the two as XLA scans; the plain versions are Python loops
over diagonals and path steps, one device launch an op.

On a CPU tensor the wrapper runs the plain versions (`viterbi_reference`).
For any other tensor it launches the kernel on the current stream or
raises; an argument the kernel does not take raises KernelArgumentError.
`viterbi_stats.launches` counts the launches.
"""
from __future__ import annotations

import weakref

import torch

from mlprobs_tpu_torch.ops import wavefront as wf
from mlprobs_tpu_torch.ops.kernels import build
from mlprobs_tpu_torch.ops.kernels.build import KernelArgumentError, check_arg

# the table block csrc/viterbi.cu reads, in floats (T_*)
TAB_SIZE = 915
_TAB_LM, _TAB_LINS, _TAB_TRANS, _TAB_VINIT, _TAB_BLOSUM = 0, 441, 462, 471, 474


def viterbi_reference(xp, yp, lx, ly, p, vinit, blosum):
    """Plain version: (dirs, end_state, score, pathlen, matches,
    scores_rev)."""
    dirs, ends, score = wf.viterbi_wavefront(xp, yp, lx, ly, p, vinit)
    plen, matches, srev = wf.viterbi_path_stats(dirs, ends, xp, yp, lx, ly,
                                                blosum)
    return dirs, ends, score, plen, matches, srev


def pack_tables(p, vinit, blosum, device) -> torch.Tensor:
    """(TAB_SIZE,) f32 table block: the log tables with their PAD row and
    column at LOG_ZERO, as `viterbi_wavefront` sets them, the initial
    distribution and the BLOSUM matrix."""
    lm = p["lmatch"].clone()
    lm[wf.PAD] = wf.LOG_ZERO
    lm[:, wf.PAD] = wf.LOG_ZERO
    lins = p["lins"].clone()
    lins[wf.PAD] = wf.LOG_ZERO
    tab = torch.empty((TAB_SIZE,), dtype=torch.float32, device=device)
    tab[_TAB_LM:_TAB_LINS] = lm.reshape(-1)
    tab[_TAB_LINS:_TAB_TRANS] = lins
    tab[_TAB_TRANS:_TAB_VINIT] = p["trans"].reshape(-1)
    tab[_TAB_VINIT:_TAB_BLOSUM] = vinit
    tab[_TAB_BLOSUM:] = blosum.reshape(-1)
    return tab


# the last table block packed on each device, with weak references to the
# tensors it was packed from and their versions: a batch that passes the
# same unmodified tables (every batch of a family) reuses it
_PACKED: dict = {}


def _packed_tables(p, vinit, blosum, device) -> torch.Tensor:
    srcs = (p["lmatch"], p["lins"], p["trans"], vinit, blosum)
    versions = tuple(t._version for t in srcs)
    hit = _PACKED.get(device)
    if (hit is not None and hit[1] == versions
            and all(r() is t for r, t in zip(hit[0], srcs))):
        return hit[2]
    tab = pack_tables(p, vinit, blosum, device)
    _PACKED[device] = (tuple(weakref.ref(t) for t in srcs), versions, tab)
    return tab


def viterbi_stats(xp, yp, lx, ly, p, vinit, blosum):
    """Viterbi of one pair batch and its path statistics, one launch.

    xp/yp (B, Lp) int8 classes, lx/ly (B,) int32; p the local model's
    log tables {lmatch (21, 21), lins (21,), trans (3, 3)}, vinit (3,)
    and blosum (21, 21), all f32 on the batch's device.  Returns (dirs
    (D, B, W) int8, end_state (B,) int32, score (B,) f32, pathlen (B,)
    int32, matches (B,) int32, scores_rev (2*Lp, B) f32).
    """
    if xp.device.type == "cpu":
        return viterbi_reference(xp, yp, lx, ly, p, vinit, blosum)
    lib = build.lib("viterbi")
    dev = xp.device
    if xp.dim() != 2:
        raise KernelArgumentError(f"xp has shape {tuple(xp.shape)}, "
                                  f"expected (B, Lp)")
    B, Lp = xp.shape
    if Lp < 1:
        raise KernelArgumentError("Lp must be at least 1")
    D, W = 2 * Lp + 1, Lp + 1
    check_arg("xp", xp, torch.int8, (B, Lp), dev)
    check_arg("yp", yp, torch.int8, (B, Lp), dev)
    check_arg("lx", lx, torch.int32, (B,), dev)
    check_arg("ly", ly, torch.int32, (B,), dev)
    for name, t, shape in (("lmatch", p["lmatch"], (21, 21)),
                           ("lins", p["lins"], (21,)),
                           ("trans", p["trans"], (3, 3)),
                           ("vinit", vinit, (3,)),
                           ("blosum", blosum, (21, 21))):
        check_arg(name, t, torch.float32, shape, dev)
    tab = _packed_tables(p, vinit, blosum, dev)
    dirs = torch.empty((D, B, W), dtype=torch.int8, device=dev)
    ends = torch.empty((B,), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    plen = torch.empty((B,), dtype=torch.int32, device=dev)
    matches = torch.empty((B,), dtype=torch.int32, device=dev)
    srev = torch.empty((2 * Lp, B), dtype=torch.float32, device=dev)
    # 0 while a pair's strips fit in one round of the block's warps; past
    # that, the column that carries a round's last lane to the next round
    column = lib.viterbi_scratch_floats(Lp)
    scratch = (torch.empty((B, column), dtype=torch.float32, device=dev)
               if column else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.viterbi_launch(
            xp.data_ptr(), yp.data_ptr(), lx.data_ptr(), ly.data_ptr(),
            tab.data_ptr(), B, Lp, dirs.data_ptr(), ends.data_ptr(),
            score.data_ptr(), plen.data_ptr(), matches.data_ptr(),
            srev.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"viterbi kernel launch failed: CUDA error {err}")
    viterbi_stats.launches += 1
    return dirs, ends, score, plen, matches, srev


viterbi_stats.launches = 0
