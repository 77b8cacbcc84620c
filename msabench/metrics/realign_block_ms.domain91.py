"""realign_block_ms.domain91 (ms, program span): one realigned block,
whatever the family's block count: the window's realign.block seconds
over their counter blocks; None where no family has the span."""
from msabench import spans


def read(ctx):
    blocks = [r for recs in spans.families(ctx) for r in recs
              if r["key"] == "realign.block"]
    n = sum(r["counts"].get("blocks", 0) for r in blocks)
    if not n:
        return None
    return 1e3 * sum(r["end"] - r["start"] for r in blocks) / n
