"""merge_self_s.twilight (s, program span): the merge's own time a family,
outside its child spans (timer merge less merge.pool, merge.tree and
merge.refine): the guide tree, the sequence weights and the merge's
Python around them.  None where the program has no child span."""

CHILDREN = ("merge.pool", "merge.tree", "merge.refine")


def read(ctx):
    got = [f.timers["merge"] - sum(f.timers.get(k, 0.0) for k in CHILDREN)
           for f in ctx.families
           if "merge" in f.timers and any(k in f.timers for k in CHILDREN)]
    return sum(got) / len(got) if got else None
