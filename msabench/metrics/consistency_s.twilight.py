"""consistency_s.twilight (s, program span): both consistency relaxations a
family, the base aligner's and the realigner's (timers consistency and
qp_consistency)."""
from msabench import readers


def read(ctx):
    return readers.mean_timer(ctx, 'consistency', 'qp_consistency')
