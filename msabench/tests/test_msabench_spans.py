"""The readers of the program's spans, steps and counters (metrics/
merge_*.twilight.py, extract_csr_s.twilight.py, msabench/spans.py) on a
hand-built context and hand-made span records, on the CPU."""
import pytest

from msabench import harness, spans

NEW = ("merge_scatter_s.twilight", "merge_fill_s.twilight",
       "merge_traceback_s.twilight", "merge_self_s.twilight",
       "merge_pass_ms.twilight", "extract_csr_s.twilight")


def family(k, timers):
    return harness.Family(k, [], 1.0, None, {}, timers, {})


def ctx(*timers):
    return harness.Context("base.twilight48", {}, {}, 1.0, 10.0, 0,
                           [family(k, t) for k, t in enumerate(timers)])


def record(rid, trace, key, seconds, parent=None, **counts):
    return {"key": key, "id": rid, "parent": parent, "trace": trace,
            "start": 0.0, "end": seconds, "counts": counts, "steps": {}}


def test_the_merge_steps_and_the_extraction():
    c = ctx({"merge": 1.0, "merge.scatter": 0.4, "merge.fill": 0.2,
             "merge.traceback": 0.02, "consistency.csr": 0.3},
            {"merge": 2.0, "merge.scatter": 0.6, "merge.fill": 0.4,
             "merge.traceback": 0.04, "consistency.csr": 0.1,
             "qp_consistency.csr": 0.2,
             # the realigner's steps are another layer's
             "qp_construction.scatter": 9.0})
    read = {n: harness.load_reader(n) for n in NEW}
    assert read["merge_scatter_s.twilight"](c) == pytest.approx(0.5)
    assert read["merge_fill_s.twilight"](c) == pytest.approx(0.3)
    assert read["merge_traceback_s.twilight"](c) == pytest.approx(0.03)
    assert read["extract_csr_s.twilight"](c) == pytest.approx(0.3)


def test_merge_self_is_the_merge_less_its_children():
    c = ctx({"merge": 1.0, "merge.pool": 0.1, "merge.tree": 0.3,
             "merge.refine": 0.5},
            {"merge": 2.0, "merge.pool": 0.2, "merge.tree": 0.4,
             "merge.refine": 1.2})
    read = harness.load_reader("merge_self_s.twilight")
    assert read(c) == pytest.approx((0.1 + 0.2) / 2)


def test_merge_pass_ms_over_the_window_families(monkeypatch):
    recs = [
        # an earlier family (the warm-up's), outside the window of two
        record(1, 1, "merge.refine", 9.0, parent=1, passes=1),
        record(5, 5, "merge.refine", 0.3, parent=6, passes=100),
        record(6, 5, "merge", 0.5, parent=7, passes=100),
        record(7, 5, "align_family", 1.0),
        # a family that ran no pass is left out of the mean
        record(9, 9, "merge.refine", 0.0, parent=10, passes=0),
        record(10, 9, "align_family", 1.0),
    ]
    monkeypatch.setattr(spans, "RECORDS", recs)
    c = ctx({}, {})
    read = harness.load_reader("merge_pass_ms.twilight")
    assert read(c) == pytest.approx(3.0)
    assert spans.merge_pass_ms(ctx({}), recs[:1]) == pytest.approx(9000.0)
    assert [len(g) for g in spans.families(c)] == [3, 2]


@pytest.mark.parametrize("name", NEW)
def test_none_where_the_keys_are_absent(monkeypatch, name):
    """A program without the spans (the parent of the PR that added
    them) has none of the keys: each reader returns None.  The merge's
    own time needs a child span beside the timer merge."""
    monkeypatch.setattr(spans, "RECORDS",
                        [record(1, 1, "align_family", 1.0)])
    c = ctx({"merge": 1.0, "consistency": 2.0, "features": 0.1})
    assert harness.load_reader(name)(c) is None
