"""family_s (s, host clock): the measured window over the families it
completed, the time a suite user pays a family."""
from msabench import readers


def read(ctx):
    return readers.seconds_per_family(ctx)
