"""The work the algorithm needs, counted from a family's true lengths,
and the peaks of one NVIDIA H100 (SXM, 700 W) it is held against.

Frozen arithmetic: the counts follow the plain recurrences of
mlprobs_tpu_torch/ops/wavefront.py and align/consistency.py at commit
30598a0 (adds and multiplies a cell, as written there; selects, masks
and the per-diagonal rescale bookkeeping are not counted), whatever
implements them.  A kernel's roofline share is the least time the chip
could take for this work, max(operations / peak rate, bytes / peak
bandwidth), over the time the trace gives its kernels.
"""
from __future__ import annotations

PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores (TF32 off)
PEAK_HBM_BYTES = 3.35e12    # bytes a second

# adds and multiplies a cell of one direction's sweep, per model: the
# state recurrences and the multiply by the diagonal's scale
SWEEP_OPS = {"hmm5": 37, "local": 21, "partition": 13}
POSTERIOR_OPS = 3           # fwd * rev * 2^scale / total, per model
MWT_OPS = 3                 # one add, two maxes
MODE_MODELS = {
    "mix": ("hmm5", "partition", "local"),
    "qp": ("hmm5", "partition"),
    "hmm5": ("hmm5",),
    "local": ("local",),
    "partition": ("partition",),
}


def rms_ops(n_models: int) -> int:
    """n squares, n - 1 adds, a scale and a square root; none for one."""
    return 2 * n_models + 1 if n_models > 1 else 0


def relax_flops(lengths, reps: int) -> float:
    """Operations of `reps` rounds of the consistency contraction:
    P'_ij = sum over z not in {i, j} of P_iz P_zj for each pair i < j
    (P_ji is its transpose), a product of L_i x L_z by L_z x L_j,
    2 L_i L_z L_j operations."""
    total = float(sum(lengths))
    ops = 0.0
    for a, li in enumerate(lengths):
        for lj in lengths[a + 1:]:
            ops += 2.0 * li * lj * (total - li - lj)
    return reps * ops


def posterior_work(mode: str, pairs, qp_exact: bool = True,
                   dense: bool = True, topk: int = 16) -> tuple[float, float]:
    """(operations, bytes) of the all-pairs posteriors of `pairs`, a
    list of (L_x, L_y), on the kernels that a benchmark attributes to
    the posterior stage (sweep, combine).

    Each model: both sweeps over every cell, then its posterior; the
    RMS of the models and the MWT fill.  Mode "qp" on the qpx route:
    the two sweeps of its partition model and the MWT over the given
    plane (the qpx kernel's hmm5 forward and backward, the posteriors
    and their RMS run elsewhere and are not counted).  Bytes: both
    residue strings read once and the output written once: the dense
    f32 plane, or `topk` (value, lane) pairs a diagonal."""
    models = MODE_MODELS[mode]
    if mode == "qp" and qp_exact:
        per_cell = 2 * SWEEP_OPS["partition"] + MWT_OPS
    else:
        per_cell = (sum(2 * SWEEP_OPS[m] + POSTERIOR_OPS for m in models)
                    + rms_ops(len(models)) + MWT_OPS)
    ops = 0.0
    nbytes = 0.0
    for lx, ly in pairs:
        ops += per_cell * lx * ly
        nbytes += lx + ly
        nbytes += 4.0 * lx * ly if dense else 8.0 * topk * (lx + ly + 1)
    return ops, nbytes


def roofline_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take for this work."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)
