"""The scaled-kernel qp route (MLPROBS_QP_EXACT=0) against the JAX
package's, on the CPU on both sides: mode "qp" on the hmm5 and Vtml200
partition models through the two kernels' plain versions, with no
[0.001, 1] filter.  The default ("1", the qpx route) stays as it was.

The JAX side runs its wavefront engine with the native host route off,
as tests/test_torch_align.py runs it.  Tolerances: CSR and dense
posteriors atol 2e-4 (a cell kept on one side only sits at the cutoff on
the other), MWT scores rtol 1e-4 and atol 1e-3, match counts exact,
final MSAs equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlprobs_tpu.align import aligner as jal  # noqa: E402
from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu.pipeline import driver as jdriver  # noqa: E402
from mlprobs_tpu_torch.align import aligner as tal  # noqa: E402
from mlprobs_tpu_torch.align import pairwise as tpw  # noqa: E402
from mlprobs_tpu_torch.core.alphabet import encode  # noqa: E402
from mlprobs_tpu_torch.pipeline import driver as tdriver  # noqa: E402
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


@pytest.fixture(params=["0", "1"], ids=["scaled", "qpx"])
def qp_route(request, monkeypatch):
    """Both packages on MLPROBS_QP_EXACT=<param>, the JAX package on its
    wavefront engine with the native route off."""
    monkeypatch.setenv("MLPROBS_QP_EXACT", request.param)
    _jax_wavefront(monkeypatch)
    yield request.param
    monkeypatch.undo()
    jpw._reset_engine_caches()


def _jax_wavefront(monkeypatch):
    """The JAX package's engine read and cached as "wavefront", then the
    variable unset: the port has no "wavefront" engine (its CPU path is
    the default "pallas") and refuses the name."""
    monkeypatch.setenv("MLPROBS_POSTERIOR_ENGINE", "wavefront")
    monkeypatch.setenv("MLPROBS_NATIVE_ROUTE", "0")
    jpw._reset_engine_caches()
    assert jpw._engine() == "wavefront"
    monkeypatch.delenv("MLPROBS_POSTERIOR_ENGINE")


def _seqs():
    recs = synthetic_family(4, 30, 60, sub=0.4, indel=0.1, seed=31)
    return [encode(s) for _, s in recs]


def _close_modulo_cutoff(got, want, atol=2e-4, cutoff=0.01):
    both = (got > 0) == (want > 0)
    assert np.abs(got - want)[both].max(initial=0.0) <= atol
    one = (got + want)[~both]
    assert np.all(np.abs(one - cutoff) <= atol)


def test_route_follows_the_switch(monkeypatch):
    """Unset or "1" is the qpx route; "0" the scaled kernels."""
    calls = []
    real = tpw._qpx_combined_skew

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tpw, "_qpx_combined_skew", spy)
    seqs = _seqs()[:2]
    monkeypatch.delenv("MLPROBS_QP_EXACT", raising=False)
    assert tpw._qp_exact()
    list(tpw.all_pairs_posteriors(seqs, "qp", device="cpu"))
    assert calls == [1]
    monkeypatch.setenv("MLPROBS_QP_EXACT", "0")
    assert not tpw._qp_exact()
    list(tpw.all_pairs_posteriors(seqs, "qp", device="cpu"))
    assert calls == [1]


def test_all_pairs_qp_match_jax(qp_route, monkeypatch):
    seqs = _seqs()

    def collect(mod, **kw):
        return {(i, j): (csr.toarray(), score, nb)
                for (i, j), csr, score, nb in mod.all_pairs_posteriors(
                    seqs, mode="qp", with_matches=True, **kw)}

    want = collect(jpw)
    got = collect(tpw, device="cpu")
    assert want.keys() == got.keys() and len(got) == 6
    for k in want:
        aw, sw, nw = want[k]
        ag, sg, ng = got[k]
        assert nw == ng
        np.testing.assert_allclose(sg, sw, rtol=1e-4, atol=1e-3)
        _close_modulo_cutoff(ag, aw)


def test_device_posterior_tensor_qp_matches_jax(qp_route, monkeypatch):
    seqs = _seqs()
    want = jpw.device_posterior_tensor(seqs, "qp")
    got = tpw.device_posterior_tensor(seqs, "qp", device="cpu")
    assert want is not None and got is not None
    _close_modulo_cutoff(got.S.numpy(), np.asarray(want.S))
    # dist = 1 - score / min(li, lj): the MWT scores to their tolerance
    lens = np.array([len(q) for q in seqs])
    m = np.minimum(lens[:, None], lens[None, :])
    np.testing.assert_allclose((1 - got.dist) * m, (1 - want.dist) * m,
                               rtol=1e-4, atol=1e-3)


def test_scaled_route_is_the_two_model_kernels(monkeypatch):
    """With "0" the qp planes are the kernels' two-model RMS (no filter):
    equal to the plain engine's `posterior` on hmm5 + partition_qp."""
    monkeypatch.setenv("MLPROBS_QP_EXACT", "0")
    seqs = _seqs()
    got = tpw.device_posterior_tensor(seqs, "qp", device="cpu")
    tabs_f, tabs_r = tpw._wf_tables("qp", None, "cpu")
    n = len(seqs)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    for chunk, X, Y, LX, LY in tpw.iter_pair_batches(
            seqs, pairs, torch.device("cpu"), force_lp=got.S.shape[-1]):
        dense, _ = tpw._wf_dense_fn(("hmm5", "partition"),
                                    lambda dev: (tabs_f, tabs_r))(X, Y, LX, LY)
        for k, (i, j) in enumerate(chunk):
            assert torch.equal(got.S[i, j], dense[k])
    # and not the qpx route's planes
    monkeypatch.setenv("MLPROBS_QP_EXACT", "1")
    exact = tpw.device_posterior_tensor(seqs, "qp", device="cpu")
    assert not torch.equal(exact.S, got.S)


def test_align_family_quickprobs_matches_jax(qp_route, monkeypatch):
    recs = synthetic_family(6, 40, 90, sub=0.2, indel=0.05, seed=5)
    want = jal.align_family(recs, config="quickprobs")
    got = tal.align_family(recs, config="quickprobs", device="cpu")
    assert got.content_hash() == want.content_hash()


def test_run_pipeline_scaled_matches_jax(monkeypatch):
    monkeypatch.setenv("MLPROBS_QP_EXACT", "0")
    _jax_wavefront(monkeypatch)
    try:
        recs = synthetic_family(6, 40, 90, sub=0.2, indel=0.05, seed=5)
        want_msa, want = jdriver.run_pipeline(recs)
        got_msa, got = tdriver.run_pipeline(recs, device="cpu")
    finally:
        monkeypatch.undo()
        jpw._reset_engine_caches()
    assert got.final_hash == want.final_hash
    assert got_msa.to_records() == want_msa.to_records()
    assert got.whole_family_realign and got.block_errors == []
