"""consistency_roofline.twilight (%, device trace): the contraction's
needed f32 operations (work.relax_flops) over the GEMM kernels' time
(readers.GEMM_KERNELS) at 67 TFLOP/s."""
from msabench import readers


def read(ctx):
    return readers.consistency_roofline(ctx)
