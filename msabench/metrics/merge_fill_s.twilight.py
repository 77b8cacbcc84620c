"""merge_fill_s.twilight (s, program span): the base aligner's merge's MWT
fills a family, host.mwt_fill of every profile merge (step
merge.fill)."""
from msabench import readers


def read(ctx):
    return readers.mean_timer(ctx, 'merge.fill')
