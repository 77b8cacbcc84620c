"""realign_block_s.domain91 (s, program span): the block realigner a
family, the spans realign.block (one a block that goes through
QuickProbs, its own qp_* spans nested) summed, the mean over the
window's families, 0 for a family that realigned none; None where no
family has the span (a program older than it)."""
from msabench import spans


def read(ctx):
    fams = spans.families(ctx)
    got = [sum(r["end"] - r["start"] for r in recs
               if r["key"] == "realign.block") for recs in fams]
    if not any(r["key"] == "realign.block" for recs in fams
               for r in recs):
        return None
    return sum(got) / len(got)
