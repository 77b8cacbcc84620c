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


# family shapes at a size a test run holds: twilight48's, and a long
# member with two cut from it (300, 70 and 50 residues: the long
# member's pairs in one bucket, the short pair in another)
SHAPES = {"twilight48": {"n": 8, "lmin": 60, "lmax": 90, "cuts": None},
          "long": {"n": 3, "lmin": 300, "lmax": 300, "sub": 0.3,
                   "indel": 0.05, "cuts": [None, [20, 90], [150, 200]]}}


def small(shape="twilight48"):
    cfg = harness.load_json("configs", "twilight48")
    cfg["family"].update(SHAPES[shape])
    return cfg


def run_cell(cell, seconds=0.1, shape="twilight48"):
    torch.set_num_threads(2)
    return harness.run(cell, BENCH, 2**32 + 11, seconds, False,
                       time.perf_counter(), device="cpu",
                       config=small(shape), log=lambda *a, **k: None)


@pytest.mark.parametrize("cell, shape", [("base.twilight48", "twilight48"),
                                         ("align.twilight48", "twilight48"),
                                         ("base.twilight48", "long")])
def test_sound_run_is_correct(cell, shape):
    r = run_cell(cell, shape=shape)
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


def test_relax_gap_reads_the_nearer_of_two_cutoffs():
    """An entry the float64 relaxation keeps with its cutoffs lowered
    and drops with them raised reads no gap either way; every other
    entry is read as before."""
    rows, cols = np.array([0, 0, 1]), np.array([0, 1, 2])
    lo = [{(0, 1): (rows, cols, np.array([0.5, 0.03, 0.4]))}]
    hi = [{(0, 1): (rows[[0, 2]], cols[[0, 2]], np.array([0.5, 0.4]))}]
    assert check.relax_gap(lo, lo, hi) == 0.0
    assert check.relax_gap(hi, lo, hi) == 0.0
    assert check.relax_gap(hi, lo) > 0.04
    off = [{(0, 1): (rows[[0, 2]], cols[[0, 2]], np.array([0.6, 0.4]))}]
    assert check.relax_gap(off, lo, hi) == pytest.approx(
        0.1 / np.sqrt(0.5 ** 2 + 0.03 ** 2 + 0.4 ** 2))
    assert check.relax_gap(lo, lo, [{(0, 2): hi[0][(0, 1)]}]) == \
        check.NO_MATCH


@pytest.mark.parametrize("tie", [check.CUTOFF_TIE, 0.5])
def test_reference_keeps_msaref_at_its_cutoff(tie, monkeypatch):
    """The reference's float64 relaxations are worked out with every
    cutoff lowered and raised by CUTOFF_TIE (far apart where it is
    wide), while msaref's own relaxation and MSA are those of its tensor
    at its cutoff: the same as msaref run without the check."""
    from msabench import generator
    from msabench.control import _same_calls
    from msabench.msaref.align import pairwise
    from msabench.msaref.align.aligner import align_family

    monkeypatch.setattr(check, "CUTOFF_TIE", tie)
    traffic = harness.load_json("traffic", "base")
    recs = generator.family(small()["family"], 7, 0)
    torch.set_num_threads(2)
    own = []
    fn = pairwise.DevicePosteriorTensor.relax_and_extract

    def kept(tensor, *a, **k):
        own.append(fn(tensor, *a, **k))
        return own[-1]
    monkeypatch.setattr(pairwise.DevicePosteriorTensor, "relax_and_extract",
                        kept)
    want = align_family(recs, device="cpu",
                        **traffic["entry_args"]).to_records()
    monkeypatch.setattr(pairwise.DevicePosteriorTensor, "relax_and_extract",
                        fn)
    ref = check.reference(traffic, recs, "cpu", relax_control=True)
    assert ref.records == want
    assert _same_calls(ref.relax_f32, own)
    assert pairwise.CUTOFF == 0.01
    if tie == 0.5:
        assert check.relax_gap(ref.relax_hi, ref.relax) > 0.1


def _unchanged_relaxation(monkeypatch):
    """A step that returns its state unchanged: the relaxation rounds of
    the main path (the tensor packed by true lengths) give back the
    packed posteriors they were given."""
    from mlprobs_tpu_torch.align import consistency

    monkeypatch.setattr(consistency, "relax_packed_rounds",
                        lambda Q, *a, **k: Q)


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


@pytest.mark.parametrize("fault, fails, shape", [
    (_unchanged_relaxation, "relax_gap", "twilight48"),
    (_half_batch_left_out, "relax_gap", "twilight48"),
    (_answer_altered, "invalid_msas", "twilight48"),
    (_unchanged_relaxation, "relax_gap", "long")])
def test_fault_is_not_correct(fault, fails, shape, monkeypatch):
    fault(monkeypatch)
    r = run_cell("base.twilight48", shape=shape)
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
        gap = check.relax_gap(ref.relax_control, ref.relax, ref.relax_hi)
        assert gap > check.limits(cell)["relax_gap"], (seed, gap)
        assert check.relax_gap(ref.relax_f32, ref.relax, ref.relax_hi) < \
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
        gap = check.relax_gap(ref.relax_control, ref.relax, ref.relax_hi)
        assert gap > check.limits(cell)["relax_gap"], (seed, gap)
        assert check.relax_gap(ref.relax_f32, ref.relax, ref.relax_hi) < \
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
