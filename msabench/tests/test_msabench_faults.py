"""A run of a cell with the timed path broken underneath comes out not
correct; a sound run comes out correct.  On the CPU at a small size:
the port's CPU path runs the kernels' plain versions, and the check's
reference (msabench/msaref) is its frozen plain copy, so a sound run
reads sp_gap 0 and a relax_gap of float32 rounding against the float64
relaxation.  The limits are the cells' own (limits/<cell>.json)."""
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from msabench import check, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def small(cfg_name="twilight48"):
    cfg = harness.load_json("configs", cfg_name)
    cfg["family"].update(n=8, lmin=60, lmax=90, cuts=None)
    return cfg


def run_cell(cell, seconds=0.1):
    torch.set_num_threads(2)
    return harness.run(cell, BENCH, 2**32 + 11, seconds, False,
                       time.perf_counter(), device="cpu",
                       config=small(), log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", ["base.twilight48", "align.twilight48"])
def test_sound_run_is_correct(cell):
    r = run_cell(cell)
    assert r["correct"], r["checks"]
    assert r["checks"]["sp_gap"]["value"] == 0.0
    assert 0.0 < r["checks"]["relax_gap"]["value"] < 1e-6


def test_relax64_equals_the_einsum_in_float64():
    """The check's float64 relaxation (a matrix product per (i, z)) and
    the reference's einsum, both in float64, agree; the weighted
    coefficients are QuickProbs' too."""
    from msabench.msaref.align import consistency

    g = torch.Generator().manual_seed(5)
    n, lp = 5, 12
    S = torch.rand((n, n, lp, lp), generator=g, dtype=torch.float64)
    S[S < 0.5] = 0.0
    S[torch.arange(n), torch.arange(n)] = 0.0
    w = np.array([0.5, 1.0, 2.0, 1.5, 0.25])
    for weights, final in ((None, None), (w, 1e-5)):
        sc, zs, ww = consistency.dense_relax_coeffs(n, weights)
        sc64, zs64, w64 = check.relax_coeffs64(n, weights)
        assert np.allclose(sc, sc64) and np.allclose(zs, zs64)
        want = consistency.relax_dense_rounds(
            S, *(torch.from_numpy(a).double() for a in (sc64, zs64, w64)),
            reps=2, final_cutoff=final)
        got = check.relax64(S, weights, reps=2, final_cutoff=final)
        assert torch.allclose(got, want, rtol=1e-12, atol=1e-15)


def test_relax_gap_reads_what_differs():
    """relax_gap: 0 for the same entries, the relative norm of a change,
    NO_MATCH for a missing call or pair; entries under MARGIN on both
    sides are not read."""
    import scipy.sparse as sp

    rows, cols = np.array([0, 0, 1]), np.array([0, 2, 1])
    ref = [{(0, 1): (rows, cols, np.array([0.5, 0.015, 0.8]))}]
    same = [{(0, 1): sp.csr_matrix(([0.5, 0.011, 0.8], (rows, cols)),
                                   shape=(2, 3))}]
    assert check.relax_gap(same, ref) == 0.0
    off = [{(0, 1): (rows, cols, np.array([0.5, 0.015, 0.4]))}]
    assert check.relax_gap(off, ref) == pytest.approx(
        0.4 / np.hypot(0.5, 0.8))
    assert check.relax_gap([], ref) == check.NO_MATCH
    assert check.relax_gap([{(0, 2): ref[0][(0, 1)]}], ref) == \
        check.NO_MATCH


def _unchanged_relaxation(monkeypatch):
    """A step that returns its state unchanged: the relaxation rounds
    give back the posteriors they were given."""
    from mlprobs_tpu_torch.align import consistency

    monkeypatch.setattr(consistency, "relax_dense_rounds",
                        lambda S, *a, **k: S)


def _half_batch_left_out(monkeypatch):
    """Half of each posterior batch left out: the second half of the
    pairs of a batch get empty posterior planes."""
    from mlprobs_tpu_torch.align import pairwise

    orig = pairwise._wf_dense_fn

    def broken(*a, **k):
        run = orig(*a, **k)

        def half(X, Y, LX, LY):
            dense, score = run(X, Y, LX, LY)
            dense[dense.shape[0] // 2:] = 0.0
            return dense, score
        return half
    monkeypatch.setattr(pairwise, "_wf_dense_fn", broken)


def _answer_altered(monkeypatch):
    """An answer altered where it is produced: the base aligner's MSA
    comes back with two columns of its first row swapped."""
    from mlprobs_tpu_torch.align import aligner

    orig = aligner.align_family

    def altered(*a, **k):
        msa = orig(*a, **k)
        res = np.flatnonzero(msa.rows[0] >= 0)
        i, j = res[0], res[-1]
        msa.rows[0, [i, j]] = msa.rows[0, [j, i]]
        return msa
    monkeypatch.setattr(aligner, "align_family", altered)


@pytest.mark.parametrize("fault, fails", [
    (_unchanged_relaxation, "relax_gap"),
    (_half_batch_left_out, "relax_gap"),
    (_answer_altered, "invalid_msas")])
def test_fault_is_not_correct(fault, fails, monkeypatch):
    fault(monkeypatch)
    r = run_cell("base.twilight48")
    assert not r["correct"], r["checks"]
    c = r["checks"][fails]
    assert c["value"] > c["limit"], r["checks"]


@pytest.mark.parametrize("cell", ["base.twilight48", "align.twilight48"])
def test_relax_control_fails_on_the_cpu(cell):
    """The relax_gap control (the reference's contraction in TF32; on
    the CPU its operands rounded to TF32) in the program's place reads
    over the cell's limit on each of three seeds, at a size a test run
    holds (the card's readings at the cell's size are PERF.md's)."""
    cfg = small()
    from msabench import generator

    wl = next(w for w in BENCH["workloads"] if w["name"] == cell)
    traffic = harness.load_json("traffic", wl["traffic"])
    torch.set_num_threads(2)
    for seed in (1, 2, 3):
        recs = generator.family(cfg["family"], seed, 0)
        ref = check.reference(traffic, recs, "cpu", relax_control=True,
                              stop_after=1)
        gap = check.relax_gap(ref.relax_control, ref.relax)
        assert gap > check.limits(cell)["relax_gap"], (seed, gap)
        assert check.relax_gap(ref.relax_f32, ref.relax) < \
            check.limits(cell)["relax_gap"]


def test_sp_control_fails_on_the_cpu():
    """The sp_gap control (the reference in the lower precision, in the
    program's place: on the CPU its bfloat16 posterior and profile
    planes; TF32 needs the card), at a size a test run holds, reads an
    sp_gap over the cell's limit on one seed of three at least (at
    N = 12 the MSA of some families does not move; the card test below
    holds the control at the cell's shape to every seed)."""
    cfg = small()
    cfg["family"].update(n=12, lmin=80, lmax=120)
    from msabench import generator

    traffic = harness.load_json("traffic", "base")
    torch.set_num_threads(2)
    gaps = []
    for seed in (1, 2, 3):
        recs = generator.family(cfg["family"], seed, 0)
        ref = check.reference_records(traffic, recs, "cpu")
        ctl = check.reference_records(traffic, recs, "cpu",
                                      check.CONTROLS["sp_gap"])
        gaps.append(check.sp_gap(ctl, ref))
    assert max(gaps) > check.limits("base.twilight48")["sp_gap"], gaps


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["base.twilight48", "align.twilight48"])
def test_relax_control_fails_on_the_card(card, cell):
    """The relax_gap control (the contraction in TF32) at the cell's
    shape on the card reads over the cell's limit on each of three
    seeds, and the reference's own float32 relaxation under it."""
    from msabench import generator

    wl = next(w for w in BENCH["workloads"] if w["name"] == cell)
    cfg = harness.load_json("configs", wl["config"])
    traffic = harness.load_json("traffic", wl["traffic"])
    for seed in (1, 2, 3):
        recs = generator.family(cfg["family"], seed, 0)
        ref = check.reference(traffic, recs, card, relax_control=True,
                              stop_after=1)
        gap = check.relax_gap(ref.relax_control, ref.relax)
        assert gap > check.limits(cell)["relax_gap"], (seed, gap)
        assert check.relax_gap(ref.relax_f32, ref.relax) < \
            check.limits(cell)["relax_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["base.twilight48", "align.twilight48"])
def test_sp_control_fails_on_the_card(card, cell):
    """The sp_gap control at the cell's shape on the card reads over
    the cell's limit on each of three seeds (msabench.control gives the
    readings at the cell's own size; PERF.md records them)."""
    from msabench import generator

    wl = next(w for w in BENCH["workloads"] if w["name"] == cell)
    cfg = harness.load_json("configs", wl["config"])
    traffic = harness.load_json("traffic", wl["traffic"])
    gaps = []
    for seed in (1, 2, 3):
        recs = generator.family(cfg["family"], seed, 0)
        ref = check.reference_records(traffic, recs, card)
        ctl = check.reference_records(traffic, recs, card,
                                      check.CONTROLS["sp_gap"])
        gaps.append(check.sp_gap(ctl, ref))
    assert min(gaps) > check.limits(cell)["sp_gap"], gaps
