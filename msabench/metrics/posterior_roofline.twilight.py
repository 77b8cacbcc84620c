"""posterior_roofline.twilight (%, device trace): the posterior stage's
needed work (work.posterior_work) at the chip's peaks over the time of
the kernels readers.POSTERIOR_KERNELS names."""
from msabench import readers


def read(ctx):
    return readers.posterior_roofline(ctx)
