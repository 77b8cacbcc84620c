"""The benchmark takes the configuration `domain91` and its cell
`align.domain91` as they stand (msabench/harness.py finds each by name),
and the cell's two readers of the block realigner's spans read a
made-up window."""
import json
from pathlib import Path

import pytest

from msabench import check, harness, spans

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "align.domain91"
READERS = ("realign_block_s.domain91", "realign_block_ms.domain91")


def test_configuration_is_found_by_name():
    cfg = harness.load_json("configs", "domain91")
    assert cfg["family"] == {"n": 91, "lmin": 100, "lmax": 150,
                             "sub": 0.1, "indel": 0.03, "cuts": None}
    assert cfg["reduced"] == [] and cfg["control"] == check.CONTROLS
    entry = next(c for c in BENCH["configs"] if c["name"] == "domain91")
    assert entry["file"] == "msabench/configs/domain91.json"
    assert entry["source"] == cfg["source"] and entry["reduced"] == []
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("domain91", "align", 1)
    assert harness.load_json("traffic", "align")["entry"] == "run_pipeline"
    lim = check.limits(CELL)
    assert lim["relax_gap"] < 9.1e-5 and lim["sp_gap"] < 8.04e-5


def test_cell_reports_family_s_and_the_block_metrics():
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, CELL,
                                                   "end_to_end")]
    assert e2e == ["setup_s", "family_s", "peak_device_gib"]
    layer = [m["name"] for m in harness.cell_metrics(BENCH, CELL,
                                                     "per_layer")]
    assert set(READERS) <= set(layer)
    for m in BENCH["per_layer"]:
        if m["name"] in READERS:
            assert (m["layer"], m["moves"], m["workloads"]) == \
                ("pipeline", "family_s", [CELL])
    # the twilight48 cells do not report them
    for cell in ("align.twilight48", "base.twilight48"):
        assert not set(READERS) & {m["name"] for m in harness.cell_metrics(
            BENCH, cell, "per_layer")}


def _rec(key, trace, start, end, **counts):
    return {"key": key, "id": 0, "parent": None, "trace": trace,
            "start": start, "end": end, "counts": counts}


def _ctx(n):
    return harness.Context(CELL, {}, {}, 1.0, 10.0, 0,
                           families=[None] * n)


@pytest.mark.parametrize("name,want", [
    # family 1: blocks of 0.5 and 1.5 s; family 2: none; family 3: 1.0 s
    ("realign_block_s.domain91", (2.0 + 0.0 + 1.0) / 3),
    ("realign_block_ms.domain91", 1e3 * 3.0 / 3),
])
def test_block_readers_on_a_made_up_window(name, want, monkeypatch):
    recs = [
        _rec("stage.base_msa", 0, 0.0, 9.0),      # the warm-up's trace
        _rec("realign.block", 0, 9.0, 19.0, blocks=1),
        _rec("stage.realign", 1, 0.0, 3.0),
        _rec("realign.block", 1, 0.0, 0.5, blocks=1, blocks_accepted=1),
        _rec("realign.block", 1, 1.0, 2.5, blocks=1, block_columns=5),
        _rec("stage.realign", 2, 3.0, 3.2),
        _rec("stage.realign", 3, 4.0, 5.5),
        _rec("realign.block", 3, 4.0, 5.0, blocks=1),
    ]
    monkeypatch.setattr(spans, "RECORDS", recs)
    read = harness.load_reader(name)
    assert read(_ctx(3)) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_block_readers_leave_out_a_program_without_the_span(name,
                                                           monkeypatch):
    """A program older than the span `realign.block` (or a window that
    realigned no block): the reader returns None and the harness leaves
    the metric out of the line."""
    monkeypatch.setattr(spans, "RECORDS", [
        _rec("stage.realign", 1, 0.0, 3.0), _rec("stage.realign", 2, 3, 4)])
    assert harness.load_reader(name)(_ctx(2)) is None
    monkeypatch.setattr(spans, "RECORDS", [])
    assert harness.load_reader(name)(_ctx(2)) is None
