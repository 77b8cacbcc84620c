"""merge_s.twilight (s, program span): the base aligner's guide tree,
progressive merge and refinement a family (timer merge)."""
from msabench import readers


def read(ctx):
    return readers.mean_timer(ctx, 'merge')
