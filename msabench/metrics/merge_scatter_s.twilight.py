"""merge_scatter_s.twilight (s, program span): the base aligner's merge's
scatter a family: the pair lists and the host profile-posterior scatter
of every profile merge (step merge.scatter)."""
from msabench import readers


def read(ctx):
    return readers.mean_timer(ctx, 'merge.scatter')
