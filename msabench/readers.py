"""Helpers the metric readers (metrics/<name>.py) share.  A reader
returns None where its run has nothing to read, and the harness then
leaves its metric out of the line."""
from __future__ import annotations

from msabench import work

# cuBLAS and CUTLASS GEMM kernels: the consistency contraction's product
GEMM_KERNELS = r"(?i)gemm|cutlass"
# the posterior stage's kernels (mlprobs_tpu_torch/ops/kernels/csrc)
POSTERIOR_KERNELS = (r"\bsweep_kernel\b|\bsweep_long_kernel\b"
                     r"|\bcombine_kernel\b|\bcombine_cluster_kernel\b")


def seconds_per_family(ctx):
    """The whole window over the families it completed."""
    return ctx.window_s / len(ctx.families) if ctx.families else None


def mean_timer(ctx, *keys):
    """Mean over the window's families of the sum of the program's stage
    timers `keys` (utils/stats.GLOBAL); None where no family has any."""
    got = [sum(f.timers.get(k, 0.0) for k in keys) for f in ctx.families
           if any(k in f.timers for k in keys)]
    return sum(got) / len(got) if got else None


def device_idle(ctx):
    """Percent of the traced window in which no kernel or copy ran."""
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def consistency_roofline(ctx):
    """Percent of the f32 peak: the contraction's needed operations over
    the window (work.relax_flops of each device relaxation's true
    lengths and rounds) over the GEMM kernels' device time."""
    if ctx.trace is None:
        return None
    flops = sum(work.relax_flops(c[1], c[2]) for f in ctx.families
                for c in f.calls if c[0] == "relax")
    t = ctx.trace.time_of(GEMM_KERNELS)
    if flops <= 0 or t <= 0:
        return None
    return 100.0 * flops / work.PEAK_F32_FLOPS / t


def posterior_roofline(ctx):
    """Percent of the roofline: the least time the posterior stage's
    needed work (work.posterior_work of each call's true lengths) could
    take on the chip, over the device time of the sweep and combine
    kernels."""
    if ctx.trace is None:
        return None
    least = 0.0
    for f in ctx.families:
        for c in f.calls:
            if c[0] == "posteriors":
                _, mode, qp_exact, dense, pairs = c
                least += work.roofline_seconds(
                    *work.posterior_work(mode, pairs, qp_exact, dense))
    t = ctx.trace.time_of(POSTERIOR_KERNELS)
    if least <= 0 or t <= 0:
        return None
    return 100.0 * least / t
