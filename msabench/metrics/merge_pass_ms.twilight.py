"""merge_pass_ms.twilight (ms, program span): one refinement pass of the
base aligner's merge, whatever the family's pass count: the span
merge.refine over its counter passes (msabench/spans.py)."""
from msabench import spans


def read(ctx):
    return spans.merge_pass_ms(ctx)
