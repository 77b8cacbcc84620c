"""Wrapper of the realigner's qpx HMM5 forward/backward CUDA kernels
(csrc/qpx.cu).

`hmm5_fb` computes what `qpx.hmm5_fb_qpx` computes, in one launch that
runs every pair's forward and backward at once: the QuickProbs-exact
forward and backward match planes, (D, B, W) views of padded
(D + 2, B, W + 1) buffers, and each pair's total, (totalF + totalB) * 0.5
of the two directions' totals, as the plain version forms it.  The JAX
package runs each direction as an XLA scan; the plain version is a
Python loop over diagonals, one device launch an op.
`hmm5_posterior` adds the plain version's chunked posterior pass
(`qpx.posterior_from_fb`), which is elementwise over a few dozen chunks
and not launch-bound.

On a CPU tensor the wrapper runs the plain version.  For any other
tensor it launches the kernels on the current stream or raises; an
argument the kernels do not take raises KernelArgumentError.
`hmm5_fb.launches` counts the launches.
"""
from __future__ import annotations

import torch

from mlprobs_tpu_torch.ops import qpx
from mlprobs_tpu_torch.ops.kernels import build
from mlprobs_tpu_torch.ops.kernels.build import KernelArgumentError, check_arg

# the table block csrc/qpx.cu reads, in floats (Q_*)
TAB_SIZE = 577
_TAB_LM, _TAB_LI, _TAB_T, _TAB_INIT, _TAB_LB, _TAB_LC = (
    0, 484, 528, 553, 558, 561)


def pack_tables(init, trans, lmatch, lins) -> torch.Tensor:
    """(TAB_SIZE,) f32 table block: the plain version's class tables
    (`qpx.class_tables`), the transitions, the initial distribution and
    LOOKUP_FLOAT's bounds and coefficients as the same f32 tensors."""
    lm, li = qpx.class_tables(lmatch, lins)
    c = qpx._consts(lmatch.device)
    return torch.cat([lm, li.reshape(-1), trans.reshape(-1), init,
                      c["lb"], c["lc"].reshape(-1)])


def hmm5_fb(xp, yp, lx, ly, init, trans, lmatch, lins):
    """Forward+backward match planes and totals of one pair batch.

    xp/yp (B, Lp) int8 classes, lx/ly (B,) int32; init (5,), trans
    (5, 5), lmatch (21, 21), lins (21, 2) log f32 on the batch's device.
    Returns (fwd_m (D, B, W), bwd_m (D, B, W), total (B,)), as
    `qpx.hmm5_fb_qpx`.
    """
    if xp.device.type == "cpu":
        return qpx.hmm5_fb_qpx(xp, yp, lx, ly, init, trans, lmatch, lins)
    lib = build.lib("qpx")
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
    for name, t, shape in (("init", init, (5,)), ("trans", trans, (5, 5)),
                           ("lmatch", lmatch, (21, 21)),
                           ("lins", lins, (21, 2))):
        check_arg(name, t, torch.float32, shape, dev)
    tab = pack_tables(init, trans, lmatch, lins)
    fwd_mp = torch.empty((D + 2, B, W + 1), dtype=torch.float32, device=dev)
    bwd_mp = torch.empty((D + 2, B, W + 1), dtype=torch.float32, device=dev)
    total_f = torch.empty((B,), dtype=torch.float32, device=dev)
    total_b = torch.empty((B,), dtype=torch.float32, device=dev)
    ring = lib.qpx_scratch_floats(Lp)   # 0: the rings fit on chip
    scratch = (torch.empty((B, ring), dtype=torch.float32, device=dev)
               if ring else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qpx_launch(
            xp.data_ptr(), yp.data_ptr(), lx.data_ptr(), ly.data_ptr(),
            tab.data_ptr(), B, Lp, fwd_mp.data_ptr(), bwd_mp.data_ptr(),
            total_f.data_ptr(), total_b.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"qpx kernel launch failed: CUDA error {err}")
    hmm5_fb.launches += 1
    total = total_f.add_(total_b).mul_(0.5)   # the plain version's order
    return fwd_mp[2:, :, 1:], bwd_mp[:D, :, :W], total


hmm5_fb.launches = 0


def hmm5_posterior(xp, yp, lx, ly, init, trans, lmatch, lins):
    """(D, B, W) qpx match posterior: `hmm5_fb`, then the plain version's
    posterior pass over its planes (`qpx.hmm5_posterior_qpx` on the CPU)."""
    fwd_m, bwd_m, total = hmm5_fb(xp, yp, lx, ly, init, trans, lmatch, lins)
    return qpx.posterior_from_fb(fwd_m, bwd_m, total, lx, ly)
