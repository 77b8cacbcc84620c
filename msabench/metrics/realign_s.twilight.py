"""realign_s.twilight (s, program span): the pipeline's realign stage a
family (run_pipeline's stage.realign mark: the realigner and
recombination)."""
from msabench import readers


def read(ctx):
    return readers.mean_timer(ctx, 'stage.realign')
