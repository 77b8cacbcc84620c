"""The program's span records (mlprobs_tpu_torch/utils/stats.GLOBAL),
kept in `RECORDS` by a sink attached when this module is imported.

Only per-layer readers (metrics/<name>.py) import it, and the harness
loads those in the traced run alone, after the warm-up: the untraced run
keeps no record, and the traced window's families are the last traces
the sink saw.  A program whose registry takes no sink (one older than
its spans) leaves `RECORDS` empty, and the readers return None.
"""
from __future__ import annotations

from mlprobs_tpu_torch.utils.stats import GLOBAL

RECORDS: list = []
if hasattr(GLOBAL, "add_sink"):
    GLOBAL.add_sink(RECORDS.append)


def families(ctx, records=None) -> list:
    """The records of the window's families, a list a family: grouped by
    trace id, the last len(ctx.families) traces."""
    traces: dict = {}
    for r in RECORDS if records is None else records:
        traces.setdefault(r["trace"], []).append(r)
    n = len(ctx.families)
    return [traces[t] for t in sorted(traces)[-n:]] if n else []


def merge_pass_ms(ctx, records=None):
    """Milliseconds a refinement pass of the base aligner's merge: a
    family's `merge.refine` seconds over its `passes`, the mean over the
    families that ran a pass; None where none did."""
    got = []
    for recs in families(ctx, records):
        refine = [r for r in recs if r["key"] == "merge.refine"]
        passes = sum(r["counts"].get("passes", 0) for r in refine)
        if passes:
            got.append(1e3 * sum(r["end"] - r["start"] for r in refine)
                       / passes)
    return sum(got) / len(got) if got else None
