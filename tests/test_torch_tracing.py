"""The port's stats registry (utils/stats.py) on the CPU: spans with ids,
parents and one trace id a family, steps that never call `add`, counters
that count what the program did, and nothing kept and nothing changed
without a sink.  One seeded N = 8 family (RCR, the whole-family realign)
through `align_family(config="pnp")` and `run_pipeline`."""
import json

import pytest

torch = pytest.importorskip("torch")

from mlprobs_tpu_torch.align import aligner, progressive  # noqa: E402
from mlprobs_tpu_torch.models import forests  # noqa: E402
from mlprobs_tpu_torch.pipeline import cli, driver  # noqa: E402
from mlprobs_tpu_torch.utils import host, stats  # noqa: E402
from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS  # noqa: E402
from mlprobs_tpu_torch.utils.synth import synthetic_family  # noqa: E402
from msabench import harness, trace  # noqa: E402

FAMILY = (8, 40, 90, 0.2, 0.05, 5)     # RCR, factor <= 0: whole realign
# the timer keys the program had before its spans, and reads still
PNP_KEYS = {"features", "posteriors", "consistency", "merge"}
PIPELINE_KEYS = {"posteriors", "consistency", "merge", "qp_posteriors",
                 "qp_consistency", "qp_construction", "qp_refinement",
                 "stage.features", "stage.classifier1", "stage.base_msa",
                 "stage.classifier3", "stage.segmentation", "stage.realign",
                 "stage.total"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain PyTorch loops (see
    test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(fn, sink: bool):
    """(result, records, timers, calls, counters, step keys) of one
    family through `fn`, with a list sink attached or with none."""
    records: list = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(STATS, "_sinks", [])
        if sink:
            STATS.add_sink(records.append)
        STATS.reset()
        out = fn()
    return (out, records, dict(STATS.timers), dict(STATS.calls),
            dict(STATS.counters), set(STATS.step_keys))


@pytest.fixture(scope="module")
def pnp():
    """The base aligner with a sink, the benchmark's WorkHooks, and the
    calls of the refinement pass and the host scatter counted."""
    seen = {"passes": 0, "entries": 0}
    real_pass = progressive.iterative_refinement_pass
    real_scatter = host.profile_posterior

    def counted_pass(*a, **k):
        seen["passes"] += 1
        return real_pass(*a, **k)

    def counted_scatter(l1, l2, starts, lens, *a, **k):
        seen["entries"] += int(lens.sum())
        return real_scatter(l1, l2, starts, lens, *a, **k)

    recs = synthetic_family(*FAMILY)
    with pytest.MonkeyPatch.context() as mp, harness.WorkHooks() as hooks:
        mp.setattr(progressive, "iterative_refinement_pass", counted_pass)
        mp.setattr(host, "profile_posterior", counted_scatter)
        got = _run(lambda: aligner.align_family(recs, config="pnp",
                                                device="cpu"), sink=True)
    return got, hooks.calls, seen


@pytest.fixture(scope="module")
def pnp_no_sink():
    """The base aligner with no sink; `_emit` counts the records made."""
    made = []
    recs = synthetic_family(*FAMILY)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(STATS, "_emit", lambda *a: made.append(a))
        got = _run(lambda: aligner.align_family(recs, config="pnp",
                                                device="cpu"), sink=False)
    return got, made


@pytest.fixture(scope="module")
def pipeline():
    """run_pipeline with a sink, the benchmark's SpanRecorder (which sees
    each `add` as a host span) and WorkHooks."""
    recs = synthetic_family(*FAMILY)
    with harness.WorkHooks() as hooks, trace.SpanRecorder(STATS) as rec:
        got = _run(lambda: driver.run_pipeline(recs, device="cpu"),
                   sink=True)
    assert got[0][1].whole_family_realign and not got[0][1].crash_fallback
    return got, hooks.calls, rec.spans


def _records(request, which):
    return request.getfixturevalue(which)[0][1]


@pytest.mark.parametrize("which", ["pnp", "pipeline"])
def test_one_trace_id_a_family(request, which):
    records = _records(request, which)
    roots = [r for r in records if r["parent"] is None]
    assert len(roots) == 1
    root = roots[0]
    assert root["key"] == ("align_family" if which == "pnp"
                           else "run_pipeline")
    assert {r["trace"] for r in records} == {root["id"]}
    assert len({r["id"] for r in records}) == len(records)
    if which == "pipeline":
        # the nested align_family calls are children, not roots
        nested = [r for r in records if r["key"] == "align_family"]
        assert len(nested) == 2
        assert all(r["parent"] != root["id"] for r in nested)


@pytest.mark.parametrize("which", ["pnp", "pipeline"])
def test_every_parent_encloses_its_children(request, which):
    records = _records(request, which)
    by_id = {r["id"]: r for r in records}
    for r in records:
        assert r["start"] <= r["end"]
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start"] <= r["start"] and r["end"] <= p["end"], \
                (p["key"], r["key"])


@pytest.mark.parametrize("which", ["pnp", "pipeline"])
def test_steps_fit_inside_their_layer(request, which):
    """A layer's steps (timers `<layer>.<step>`) sum to no more than its
    span, in the timers and on each record that carries them."""
    _, records, timers, calls, _, step_keys = \
        request.getfixturevalue(which)[0]
    layers = {k.rsplit(".", 1)[0] for k in step_keys}
    assert {"merge"} <= layers
    if which == "pipeline":
        assert {"qp_construction", "qp_refinement"} <= layers
    for layer in layers:
        steps = sum(timers[k] for k in step_keys
                    if k.rsplit(".", 1)[0] == layer)
        assert 0 < steps <= timers[layer]
    for r in records:
        assert sum(s for s, _ in r["steps"].values()) <= \
            r["end"] - r["start"]
    for k in ("merge.scatter", "merge.fill", "merge.traceback"):
        assert calls[k] > 0


def test_counters_count_the_calls(pnp):
    """`passes` counts the refinement passes and `scatter_entries` the
    entries handed to the host scatter; the spans carry them."""
    (_, records, _, _, counters, _), _, seen = pnp
    assert counters["passes"] == seen["passes"] > 0
    assert counters["scatter_entries"] == seen["entries"] > 0
    refine = [r for r in records if r["key"] == "merge.refine"]
    assert len(refine) == 1
    assert refine[0]["counts"]["passes"] == seen["passes"]
    assert 0 <= counters.get("passes_changed", 0) <= counters["passes"]
    assert counters["merges"] == FAMILY[0] - 1
    assert counters["fill_cells"] > 0 and counters["csr_entries"] > 0


@pytest.mark.parametrize("which,key", [("pnp", "posteriors"),
                                       ("pipeline", "posteriors"),
                                       ("pipeline", "qp_posteriors")])
def test_posterior_counters_equal_work_hooks(request, which, key):
    """`pairs` and `cells` on a posterior span equal what the benchmark's
    WorkHooks records for the same call."""
    (_, records, *_), calls = request.getfixturevalue(which)[:2]
    spans = [r for r in records if r["key"] == key]
    posts = [c for c in calls if c[0] == "posteriors"]
    mode = {"posteriors": lambda m: m != "qp",
            "qp_posteriors": lambda m: m == "qp"}[key]
    posts = [c for c in posts if mode(c[1])]
    assert len(spans) == len(posts) == 1
    pairs = posts[0][4]
    assert spans[0]["counts"]["pairs"] == len(pairs) == 28
    assert spans[0]["counts"]["cells"] == sum(a * b for a, b in pairs)


def test_no_sink_keeps_no_record_and_keeps_the_timers(pnp_no_sink):
    (_, records, timers, calls, _, step_keys), made = pnp_no_sink
    assert records == [] and made == []
    assert PNP_KEYS <= set(timers)
    assert {"merge.scatter", "merge.fill", "merge.traceback"} <= step_keys
    assert all(calls[k] == 1 for k in PNP_KEYS)


def test_span_recorder_sees_spans_and_no_counter(pipeline):
    """Each span reaches the benchmark's SpanRecorder once, through
    `add`; steps and counters never do, and a family stays within 40
    calls."""
    (_, records, timers, _, counters, step_keys), _, spans = pipeline
    keys = [k for k, _, _ in spans]
    assert len(keys) == len(records) <= 40
    assert PIPELINE_KEYS <= set(keys)
    assert not set(keys) & set(counters)
    assert not set(keys) & step_keys
    assert sorted(keys) == sorted(r["key"] for r in records)


def test_crash_fallback_is_counted_without_add(monkeypatch):
    def broken(*a):
        raise ValueError("classifier 3 broke")

    monkeypatch.setattr(forests, "classify_realign_strategy", broken)
    recs = synthetic_family(*FAMILY)
    with trace.SpanRecorder(STATS) as rec:
        (msa, rep), records, timers, _, counters, _ = _run(
            lambda: driver.run_pipeline(recs, device="cpu"), sink=True)
    assert rep.crash_fallback and rep.error.startswith("ValueError@")
    assert counters["pipeline.crash_fallback"] == 1
    assert "pipeline.crash_fallback" not in timers
    assert all(k != "pipeline.crash_fallback" for k, _, _ in rec.spans)
    assert "stage.fallback" in timers
    root = next(r for r in records if r["parent"] is None)
    assert root["counts"]["pipeline.crash_fallback"] == 1


def test_a_sink_changes_no_alignment(pnp, pnp_no_sink):
    assert (pnp[0][0].content_hash()
            == pnp_no_sink[0][0].content_hash())


def test_registry_layers_steps_and_summary():
    """Sub-spans and steps keyed by the innermost layer; the summary's
    self time and counts; reset keeps sinks."""
    st = stats.Stats()
    got: list = []
    st.add_sink(got.append)
    with st.span("root"):
        with st.span("stage.a"):
            with st.span("merge"):
                with st.sub("tree"):
                    with st.step("fill"):
                        st.count("fill_cells", 6)
                with st.step("fill"):
                    pass
    with st.step("fill"):
        pass
    st.remove_sink(got.append)
    with st.span("merge"):
        pass
    assert [r["key"] for r in got] == ["merge.tree", "merge", "stage.a",
                                       "root"]
    assert st.calls["merge.fill"] == 2 and st.calls["fill"] == 1
    assert st.calls["merge"] == 2 and len(got) == 4
    tree, merge, stage, root = got
    assert tree["steps"]["merge.fill"][1] == 1
    assert merge["steps"]["merge.fill"][1] == 2
    assert root["counts"] == {"fill_cells": 6}
    s = stats.summary(got)
    assert s["merge"]["counts"] == {"fill_cells": 6}
    assert s["merge"]["self_s"] == pytest.approx(
        (merge["end"] - merge["start"]) - (tree["end"] - tree["start"]))
    assert s["root"]["calls"] == 1
    d = st.to_dict()
    assert d["time.merge"] > 0 and d["calls.merge.fill"] == 2
    assert d["count.fill_cells"] == 6
    st.add_sink(got.append)
    st.reset()
    assert not st.timers and not st.counters and st._sinks


def test_cli_verbose_line_has_the_span_summary(tmp_path, capsys):
    sinks = list(STATS._sinks)
    recs = synthetic_family(4, 20, 30, 0.3, 0.1, 3)
    inp = tmp_path / "in.fa"
    inp.write_text("".join(f">{h}\n{s}\n" for h, s in recs))
    assert cli.main(["base", str(inp), str(tmp_path / "out.fa"), "-v",
                     "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spans = line["spans"]
    assert spans["align_family"]["calls"] == 1
    assert spans["merge"]["counts"]["merges"] == 3
    assert spans["merge"]["self_s"] <= spans["merge"]["total_s"]
    assert "time.merge" in line["stats"]
    assert not any(k.startswith("mem.") for k in line["stats"])
    assert STATS._sinks == sinks
