"""The port's QuickProbs-role realigner against the JAX package: guide
trees and weights, the selectivity machinery, the weighted relaxation,
the qp posterior tensor and `align_family(config="quickprobs")`.

Host numpy code (trees, weights, distances, RNG streams, the z filter)
must be equal exactly.  The host weighted relaxation is compared with the
JAX package's scipy route (its native OpenMP engine patched out) to
rtol 1e-9 with equal supports.  Posteriors and the device relaxation use
the tolerances of tests/test_torch_align.py; final MSAs are equal.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from mlprobs_tpu.align import aligner as jal  # noqa: E402
from mlprobs_tpu.align import consistency as jcons  # noqa: E402
from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu.align import tree as jtree  # noqa: E402
from mlprobs_tpu.align import tree_extra as jtx  # noqa: E402
from mlprobs_tpu.utils import qprand as jqr  # noqa: E402
from mlprobs_tpu_torch.align import aligner as tal  # noqa: E402
from mlprobs_tpu_torch.align import consistency as tcons  # noqa: E402
from mlprobs_tpu_torch.align import pairwise as tpw  # noqa: E402
from mlprobs_tpu_torch.align import tree as ttree  # noqa: E402
from mlprobs_tpu_torch.align import tree_extra as ttx  # noqa: E402
from mlprobs_tpu_torch.utils import qprand as tqr  # noqa: E402
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


@pytest.fixture
def jax_wavefront(monkeypatch):
    """The JAX package on its wavefront engine with the native route off.

    The JAX package reads its engine once and caches it; the variable is
    then unset again, because the port has no "wavefront" engine (its
    CPU path is the default "pallas") and refuses the name."""
    monkeypatch.setenv("MLPROBS_POSTERIOR_ENGINE", "wavefront")
    monkeypatch.setenv("MLPROBS_NATIVE_ROUTE", "0")
    jpw._reset_engine_caches()
    assert jpw._engine() == "wavefront"
    monkeypatch.delenv("MLPROBS_POSTERIOR_ENGINE")
    yield
    monkeypatch.undo()
    jpw._reset_engine_caches()


def _dist(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.random((n, n))
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    return d


@pytest.mark.parametrize("n", [2, 5, 13])
def test_trees_and_weights_match_jax(n):
    d = _dist(n, seed=n)
    pairs = (
        (jtree.upgma(d, variance_id=1), ttree.upgma(d, variance_id=1)),
        (jtx.slink(d), ttx.slink(d)),
        (jtx.chained(n), ttx.chained(n)),
    )
    for jroot, troot in pairs:
        assert ttx.to_newick(troot) == jtx.to_newick(jroot)
        assert np.array_equal(ttree.qp_weights(troot, n),
                              jtree.qp_weights(jroot, n))
        assert np.array_equal(ttx.subtree_distances(troot, n),
                              jtx.subtree_distances(jroot, n))
        assert ttree.leaves(troot) == jtree.leaves(jroot)
    text = jtx.to_newick(pairs[0][0])
    assert (ttx.to_newick(ttx.parse_newick(text))
            == jtx.to_newick(jtx.parse_newick(text)))


@pytest.mark.parametrize("mode", ["subtree", "similarity", "seed"])
@pytest.mark.parametrize("norm", ["no", "stochastic", "ranked", "rankedrow"])
def test_selectivity_distances_match_jax(mode, norm):
    n = 9
    d = _dist(n, seed=3)
    sub = jtx.subtree_distances(jtree.upgma(d), n)
    d = d * 3.0   # above 1, so that "stochastic" divides by the max
    want = jcons.selectivity_distances(mode, d, subtree=sub,
                                       selectivity=20.0, normalization=norm)
    got = tcons.selectivity_distances(mode, d, subtree=sub,
                                      selectivity=20.0, normalization=norm)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_qprand_and_z_acceptance_match_jax():
    assert np.array_equal(tqr.consistency_seed_matrix(11),
                          jqr.consistency_seed_matrix(11))
    assert np.array_equal(tqr.seed_selection_ids(7, 40),
                          jqr.seed_selection_ids(7, 40))
    a, b = tqr.Mt19937Stream(), jqr.Mt19937Stream()
    assert ([a.det_uniform_int(0, k) for k in range(1, 300)]
            == [b.det_uniform_int(0, k) for k in range(1, 300)])
    x = np.random.default_rng(4).random(50).astype(np.float32)
    assert np.array_equal(tqr.z_accept_row(1234, x),
                          jqr.z_accept_row(1234, x))
    d = _dist(10, seed=5)
    seeds = jqr.consistency_seed_matrix(10)
    for kind in ("deterministic", "triangle_lowpass", "triangle_highpass",
                 "triangle_midpass", "homograph_lowpass"):
        for fn in ("sum", "min", "max", "avg"):
            for i, j in ((0, 1), (3, 7), (2, 9)):
                kw = dict(seed=int(seeds[i, j]), function=fn,
                          filter_kind=kind, selectivity=0.6)
                assert (tcons.z_acceptance(d, i, j, **kw)
                        == jcons.z_acceptance(d, i, j, **kw))
    assert tcons.parkmiller(987654) == jcons.parkmiller(987654)


def _posts(lengths, seed):
    rng = np.random.default_rng(seed)
    n = len(lengths)
    posts = {}
    for i in range(n):
        for j in range(i + 1, n):
            m = sp.random(lengths[i], lengths[j], density=0.15,
                          random_state=int(rng.integers(1 << 30)),
                          format="csr", dtype=np.float64)
            m.data = 0.01 + 0.99 * m.data
            posts[(i, j)] = m
    return posts


@pytest.mark.parametrize("filtered", [False, True],
                         ids=["accept-all", "stochastic-filter"])
def test_relax_sparse_weighted_matches_jax_scipy_route(monkeypatch,
                                                       filtered):
    monkeypatch.setattr(jcons, "relax_native", lambda *a, **kw: None)
    lengths = [23, 31, 17, 28, 25, 20]
    posts = _posts(lengths, seed=6)
    w = np.random.default_rng(7).random(len(lengths)) + 0.1
    kw = dict(reps=2, selfweight=3.0, selectivity=0.7 if filtered else 200.0,
              distances=_dist(len(lengths), 8) if filtered else None,
              final_cutoff=1e-5)
    want = jcons.relax_sparse_weighted(posts, lengths, w, **kw)
    got = tcons.relax_sparse_weighted(posts, lengths, w, **kw)
    assert want.keys() == got.keys()
    for k in want:
        a, b = want[k].tocsr(), got[k].tocsr()
        a.sort_indices()
        b.sort_indices()
        assert np.array_equal(a.indptr, b.indptr)
        assert np.array_equal(a.indices, b.indices)
        np.testing.assert_allclose(b.data, a.data, rtol=1e-9, atol=0)


def _close_modulo_cutoff(got, want, atol=2e-4, cutoff=0.01):
    """Equal within atol; a cell kept on one side only sits at the
    cutoff on the other (a 1e-7 difference may straddle the threshold)."""
    both = (got > 0) == (want > 0)
    assert np.abs(got - want)[both].max(initial=0.0) <= atol
    one = (got + want)[~both]
    assert np.all(np.abs(one - cutoff) <= atol)


def test_qp_tensor_and_weighted_relaxation_match_jax(jax_wavefront):
    seqs = [np.asarray(s[s >= 0]) for s in jal.MSA.from_unaligned(
        synthetic_family(5, 40, 100, 0.3, 0.1, 7)).rows]
    want = jpw.device_posterior_tensor(seqs, "qp", None)
    got = tpw.device_posterior_tensor(seqs, "qp", None, device="cpu")
    assert want is not None and got is not None
    _close_modulo_cutoff(got.S.numpy(), np.asarray(want.S))
    # dist = 1 - score / min(li, lj): the MWT scores' rtol 1e-4 / atol
    # 1e-3, over lengths >= 40 (the qpx planes differ by XLA's FMAs)
    np.testing.assert_allclose(got.dist, want.dist, rtol=0, atol=2e-4)
    w = jcons.saturate_weights(
        jtree.qp_weights(jtree.upgma(want.dist), len(seqs)))
    kw = dict(weights=w, reps=2, selfweight=3.0, selectivity=200.0,
              final_cutoff=1e-5)
    rw = want.relax_and_extract(**kw)
    rg = got.relax_and_extract(**kw)
    assert rw.keys() == rg.keys()
    for k in rw:
        _close_modulo_cutoff(rg[k].toarray(), rw[k].toarray(), cutoff=1e-5)


def test_qp_pair_posteriors_match_jax(jax_wavefront):
    """The tiny-family route: sparse top-k posteriors and MWT scores."""
    seqs = [np.asarray(s[s >= 0]) for s in jal.MSA.from_unaligned(
        synthetic_family(3, 40, 100, 0.3, 0.1, 8)).rows]
    want = {k: (c.toarray(), s) for k, c, s in
            jpw.all_pairs_posteriors(seqs, mode="qp")}
    got = {k: (c.toarray(), s) for k, c, s in
           tpw.all_pairs_posteriors(seqs, mode="qp", device="cpu")}
    assert want.keys() == got.keys()
    for k in want:
        _close_modulo_cutoff(got[k][0], want[k][0])
        np.testing.assert_allclose(got[k][1], want[k][1], rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("fam", [(6, 40, 90, 0.2, 0.05, 5),
                                 (2, 40, 90, 0.2, 0.05, 5)],
                         ids=["N6-tensor", "N2-tiny"])
def test_align_family_quickprobs_matches_jax(jax_wavefront, fam):
    records = synthetic_family(*fam)
    want = jal.align_family(records, config="quickprobs")
    report: dict = {}
    got = tal.align_family(records, config="quickprobs", report=report,
                           device="cpu")
    if fam[0] < 3:
        assert report["consistency_engine"] == "host"
        assert report["consistency_downgrade"] == "tiny_family"
    else:
        assert report["consistency_engine"] == "device"
        assert "consistency_downgrade" not in report
    assert got.content_hash() == want.content_hash()
