"""The port's posterior stage, consistency and pnp aligner against the
JAX package, stage by stage, on seeded inputs (CPU on both sides).

The JAX side runs as its own CPU tests run it: the wavefront engine
(MLPROBS_POSTERIOR_ENGINE=wavefront) with the native host route off
(MLPROBS_NATIVE_ROUTE=0), so that its posteriors, dense tensor and
feature pass take the device code paths the port copies.  Tolerances:
tables to 1e-6 relative (XLA's and PyTorch's f32 exp differ in the last
bit); posteriors 2e-4 (the JAX package's own kernel-vs-scan bound); MWT
scores rtol 1e-4 / atol 1e-3; match counts, FamilyStats and final MSAs
exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlprobs_tpu.align import aligner as jal  # noqa: E402
from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu_torch.align import aligner as tal  # noqa: E402
from mlprobs_tpu_torch.align import consistency as tcons  # noqa: E402
from mlprobs_tpu_torch.align import pairwise as tpw  # noqa: E402
from mlprobs_tpu_torch.core.alphabet import encode  # noqa: E402
from mlprobs_tpu_torch.models import params as tmp  # noqa: E402
from mlprobs_tpu_torch.utils.synth import synthetic_family  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain PyTorch loops: their tensors are
    small, and parallel test workers with a thread pool each would
    oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LEAVE = 0.170705


@pytest.fixture
def jax_wavefront(monkeypatch):
    """The JAX package on its wavefront engine with the native route off."""
    monkeypatch.setenv("MLPROBS_POSTERIOR_ENGINE", "wavefront")
    monkeypatch.setenv("MLPROBS_NATIVE_ROUTE", "0")
    jpw._reset_engine_caches()
    yield
    monkeypatch.undo()
    jpw._reset_engine_caches()


def _seqs(n=4, lo=40, hi=90, seed=11):
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, 20, hi)
    out = []
    for _ in range(n):
        s = np.where(rng.random(hi) < 0.5, rng.integers(0, 20, hi), anc)
        out.append(s[: int(rng.integers(lo, hi))].astype(np.int8))
    return out


@pytest.mark.parametrize("mode", ["mix", "qp", "local", "partition"])
def test_tables_from_numpy(mode):
    """The carry-across tables equal the JAX PROB_TABLES (to the last
    bit of f32 exp) and the port's own loader (exactly)."""
    tf, tr = tmp.tables_from_numpy(*jpw.native_tables(mode, LEAVE))
    jf, jr = jpw._wf_tables(mode, LEAVE)
    of, orr = tpw._wf_tables(mode, LEAVE, "cpu")
    for tabs, jt, own in ((tf, jf, of), (tr, jr, orr)):
        for m in jt:
            for k, v in jt[m].items():
                np.testing.assert_allclose(tabs[m][k].numpy(),
                                           np.asarray(v), rtol=1e-6)
                assert torch.equal(tabs[m][k], own[m][k])


@pytest.mark.parametrize("mode", ["mix", "local"])
def test_all_pairs_posteriors_match_jax(jax_wavefront, mode):
    """CSRs, scores and match counts, compared as tests/test_pallas.py
    compares its engines."""
    seqs = _seqs()

    def collect(mod, **kw):
        return {
            (i, j): (csr.toarray(), score, nb)
            for (i, j), csr, score, nb in mod.all_pairs_posteriors(
                seqs, mode=mode, leave_prob=LEAVE, with_matches=True, **kw)
        }

    want = collect(jpw)
    got = collect(tpw, device="cpu")
    assert want.keys() == got.keys()
    for k in want:
        aw, sw, nw = want[k]
        ag, sg, ng = got[k]
        assert nw == ng
        np.testing.assert_allclose(sg, sw, rtol=1e-4, atol=1e-3)
        both = (aw > 0) & (ag > 0)
        np.testing.assert_allclose(ag[both], aw[both], rtol=1e-3, atol=2e-5)
        assert (set(map(tuple, np.argwhere(aw >= 0.1)))
                == set(map(tuple, np.argwhere(ag >= 0.1))))


def _close_modulo_cutoff(got, want, atol=2e-4, cutoff=0.01):
    """Equal within atol; a cell kept on one side only sits at the
    cutoff on the other (a 1e-7 difference may straddle the threshold)."""
    both = (got > 0) == (want > 0)
    assert np.abs(got - want)[both].max(initial=0.0) <= atol
    one = (got + want)[~both]
    assert np.all(np.abs(one - cutoff) <= atol)


def test_dense_tensor_and_relaxation_match_jax(jax_wavefront):
    seqs = _seqs(n=5, seed=12)
    want = jpw.device_posterior_tensor(seqs, "mix", LEAVE)
    got = tpw.device_posterior_tensor(seqs, "mix", LEAVE, device="cpu")
    assert want is not None and got is not None
    assert want.pairs == got.pairs
    _close_modulo_cutoff(got.S.numpy(), np.asarray(want.S))
    np.testing.assert_allclose(got.dist, want.dist, rtol=0, atol=1e-5)
    # the top-64 extraction loses nothing: it equals thresholding the
    # dense planes
    S = got.S.numpy()
    for (i, j), csr in got.extract_csrs().items():
        dense = S[i, j][: len(seqs[i]), : len(seqs[j])]
        assert (csr != tcons.sparsify(dense)).nnz == 0
    rw = want.relax_and_extract(reps=2)
    rg = got.relax_and_extract(reps=2)
    assert rw.keys() == rg.keys()
    for k in rw:
        _close_modulo_cutoff(rg[k].toarray(), rw[k].toarray())


def test_family_stats_match_jax(jax_wavefront):
    seqs = _seqs(n=5, seed=13)
    want = jal.family_viterbi_stats(seqs, with_features=True)
    got = tal.family_viterbi_stats(seqs, with_features=True, device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# (n, lmin, lmax, substitution rate, indel rate, seed): a twilight-zone
# family (pid class 0: mix mode), a close one (class 3: partition), and a
# pair (N < 3: sparse top-k posteriors and the host relaxation)
FAMILIES = [(5, 50, 110, 0.6, 0.1, 1), (6, 50, 110, 0.15, 0.05, 2),
            (2, 50, 110, 0.6, 0.1, 3)]


@pytest.mark.parametrize("fam", FAMILIES,
                         ids=["N5-mix", "N6-partition", "N2-tiny"])
def test_align_family_matches_jax(jax_wavefront, fam):
    records = synthetic_family(*fam)
    seqs = [encode(s) for _, s in records]
    stats = tal.family_viterbi_stats(seqs, device="cpu")
    assert stats.pid_class == (0 if fam[3] > 0.5 else 3)
    want = jal.align_family(records, config="pnp")
    report: dict = {}
    got = tal.align_family(records, config="pnp", report=report,
                           device="cpu")
    if fam[0] < 3:
        assert report["consistency_engine"] == "host"
        assert report["consistency_downgrade"] == "tiny_family"
    else:
        assert report["consistency_engine"] == "device"
        assert "consistency_downgrade" not in report
    assert got.content_hash() == want.content_hash()


def _valid(msa, records):
    rows = dict(msa.to_records())
    return (len({len(r) for r in rows.values()}) == 1
            and all(rows[h].replace("-", "") == s for h, s in records))


def test_oom_in_the_tensor_is_recorded_and_taken_on_the_host(monkeypatch):
    """The reference's one downgrade: device OOM building the consistency
    tensor sends the family to the sparse posteriors and the host
    relaxation, and the report says so."""
    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")

    monkeypatch.setattr(tpw, "device_posterior_tensor", oom)
    records = synthetic_family(*FAMILIES[0])
    report: dict = {}
    msa = tal.align_family(records, report=report, device="cpu")
    assert report["consistency_engine"] == "host"
    assert report["consistency_downgrade"].startswith("oom_tensor")
    assert _valid(msa, records)


def test_batches_shrink_to_one_pair_under_a_small_budget(monkeypatch):
    """A pair whose planes fill the budget runs alone (B = 1) on the same
    device, with the same results as in a full batch."""
    seqs = _seqs(n=4, seed=14)
    full = list(tpw.all_pairs_posteriors(seqs, "mix", LEAVE, device="cpu"))
    monkeypatch.setattr(tpw, "engine_budgets", lambda *a: (80 * 128 * 128,
                                                           1 << 40))
    assert tpw._wf_batch_size(128, torch.device("cpu")) == 1
    single = list(tpw.all_pairs_posteriors(seqs, "mix", LEAVE,
                                           device="cpu"))
    assert [k for k, *_ in single] == [k for k, *_ in full]
    for (_, a, sa), (_, b, sb) in zip(full, single):
        assert sa == sb and (a != b).nnz == 0
