"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name under msabench/."""
import json
import re
import shutil
from pathlib import Path

import pytest

from msabench import check, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["msabench"]
    assert len(BENCH["command"]) <= 32
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_texts():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    for n in names:
        assert NAME.match(n), n
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for m in BENCH["per_layer"]:
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_enough(cell):
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                   "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell, "per_layer")
    for m in harness.cell_metrics(BENCH, cell, "per_layer"):
        assert m["moves"] in e2e, (cell, m["name"])


def test_every_file_is_found_by_name():
    for w in BENCH["workloads"]:
        assert harness.load_json("configs", w["config"])["family"]
        assert harness.load_json("traffic", w["traffic"])["entry"]
        assert set(json.loads((harness.HERE / "limits" /
                               f"{w['name']}.json").read_text())
                   ["limits"]) == {"failed_families", "invalid_msas",
                                   "relax_gap", "sp_gap"}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        # the configuration names the controls that check.py runs
        assert json.loads((ROOT / c["file"]).read_text())["control"] == \
            check.CONTROLS
        assert c["file"].startswith("msabench/")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_a_new_file_is_picked_up_without_editing(tmp_path, monkeypatch):
    """A configuration, a traffic mix and a metric added as new files
    are found by the names a new entry gives them."""
    copy = tmp_path / "msabench"
    shutil.copytree(harness.HERE, copy,
                    ignore=shutil.ignore_patterns("msaref", "__pycache__"))
    cfg = json.loads((copy / "configs" / "twilight48.json").read_text())
    cfg["family"]["n"] = 96
    (copy / "configs" / "sector96.json").write_text(json.dumps(cfg))
    (copy / "traffic" / "base_np.json").write_text(json.dumps(
        {"entry": "align_family", "entry_args": {"config": "pnp"},
         "env": {}}))
    (copy / "metrics" / "launches.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    monkeypatch.setattr(harness, "HERE", copy)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "base_np.sector96",
                               "config": "sector96",
                               "traffic": "base_np", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "launches", "unit": "1",
                               "better": "lower",
                               "source": "program_counter", "layer": "x",
                               "moves": "family_s",
                               "workloads": ["base_np.sector96"]})
    assert harness.load_json("configs", "sector96")["family"]["n"] == 96
    assert harness.load_json("traffic", "base_np")["entry"] == \
        "align_family"
    names = [m["name"] for m in harness.cell_metrics(
        bench, "base_np.sector96", "per_layer")]
    assert names == ["launches"]
    assert harness.load_reader("launches")(None) == 7.0
