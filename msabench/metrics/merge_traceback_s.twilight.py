"""merge_traceback_s.twilight (s, program span): the base aligner's
merge's MWT tracebacks a family, host.mwt_traceback of every profile
merge (step merge.traceback)."""
from msabench import readers


def read(ctx):
    return readers.mean_timer(ctx, 'merge.traceback')
