"""The port's sector relaxation (align/sector.py) against the JAX
package's and scipy's, and the aligners' sector route over the dense
tensor's budget, on the CPU on both sides.

Relaxed posteriors agree to atol 2e-4 and rtol 1e-4 (the posterior
tolerance of the JAX package's own tests; the products sum in another
order than XLA's); a cell kept on one side only sits at a cutoff on the
other.  The budgets are forced small, so that the sector plan takes
several pair blocks (as tests/test_sector.py does), and so that the
aligners take the sector route on both sides; their MSAs must be equal.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from mlprobs_tpu.align import aligner as jal  # noqa: E402
from mlprobs_tpu.align import consistency as jcons  # noqa: E402
from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu.align import sector as jsector  # noqa: E402
from mlprobs_tpu.core import config as jconfig  # noqa: E402
from mlprobs_tpu_torch.align import aligner as tal  # noqa: E402
from mlprobs_tpu_torch.align import consistency as tcons  # noqa: E402
from mlprobs_tpu_torch.align import pairwise as tpw  # noqa: E402
from mlprobs_tpu_torch.align import sector as tsector  # noqa: E402
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
    """The JAX package on its wavefront engine with the native route off."""
    monkeypatch.setenv("MLPROBS_POSTERIOR_ENGINE", "wavefront")
    monkeypatch.setenv("MLPROBS_NATIVE_ROUTE", "0")
    jpw._reset_engine_caches()
    yield
    monkeypatch.undo()
    jpw._reset_engine_caches()


# three pair blocks of 4 at N = 11, Lp = 128 (tests/test_sector.py's)
SMALL_BUDGET = 11 * 128 * 128 * 8 * 3


def _synthetic_posts(n=11, seed=5, max_len=40):
    """tests/test_sector.py's posteriors: a noisy diagonal band."""
    rng = np.random.default_rng(seed)
    lengths = list(rng.integers(max_len // 2, max_len, n))
    posts = {}
    for i in range(n):
        for j in range(i + 1, n):
            li, lj = lengths[i], lengths[j]
            dense = np.zeros((li, lj), np.float32)
            for r in range(li):
                c = int(r * lj / li)
                for dc in (-1, 0, 1):
                    if 0 <= c + dc < lj and rng.random() < 0.8:
                        dense[r, c + dc] = rng.uniform(0.01, 0.9)
            posts[(i, j)] = sp.csr_matrix(dense)
    return posts, lengths


def _close(got, want, cutoffs=(0.01,), atol=2e-4, rtol=1e-4):
    assert got.keys() == want.keys()
    for key in want:
        g, w = got[key].toarray(), want[key].toarray()
        both = (g > 0) == (w > 0)
        np.testing.assert_allclose(g[both], w[both], atol=atol, rtol=rtol)
        one = (g + w)[~both]
        assert all(min(abs(v - c) for c in cutoffs) <= atol for v in one)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reps", [1, 2])
def test_sector_matches_jax_and_scipy(weighted, reps):
    """Several pair blocks: the port's sectors against the JAX package's
    sectors at the same budget and against the scipy relaxation."""
    posts, lengths = _synthetic_posts(seed=5 + reps)
    n = len(lengths)
    kw = {}
    if weighted:
        kw = {"weights": np.random.default_rng(7).uniform(0.5, 2.0, n),
              "selfweight": 3.0, "selectivity": 200.0}
    rl = tsector.SectorRelaxer(lengths, budget=SMALL_BUDGET, device="cpu")
    jrl = jsector.SectorRelaxer(lengths, budget=SMALL_BUDGET)
    assert (rl.b, rl.nblocks) == (jrl.b, jrl.nblocks) and rl.nblocks >= 3
    sc, zs, w = tcons.dense_relax_coeffs(n, kw.get("weights"))
    got = rl.relax(posts, sc, zs, w, reps=reps)
    want = jrl.relax(posts, sc, zs, w, reps=reps)
    _close(got, want)
    if weighted:
        scipy_want = tcons.relax_sparse_weighted(
            posts, lengths, kw["weights"], reps=reps, distances=None)
    else:
        scipy_want = tcons.relax_sparse(posts, lengths, reps=reps)
    _close(got, scipy_want)


def test_relax_sector_device_final_cutoff_matches_jax():
    """QuickProbs' last round re-sparsifies at 1e-5, through the entry
    point the aligners call."""
    posts, lengths = _synthetic_posts(n=9, seed=3)
    weights = np.random.default_rng(8).uniform(0.5, 2.0, 9)
    report = {}
    got = tsector.relax_sector_device(
        posts, lengths, reps=2, weights=weights, final_cutoff=1e-5,
        device="cpu", budget=SMALL_BUDGET, report=report)
    want = jsector.SectorRelaxer(lengths, budget=SMALL_BUDGET).relax(
        posts, *jcons.dense_relax_coeffs(9, weights), reps=2,
        final_cutoff=1e-5)
    _close(got, want, cutoffs=(0.01, 1e-5))
    assert report["sector"]["b"] < 9 and report["sector"]["sectors"] >= 6


def test_sector_ties_keep_the_lowest_columns():
    """Uniform posteriors relax to rows of 40 equal values: the 24 kept
    are the lowest columns, as the JAX package's lax.top_k keeps them."""
    lengths = [1, 40, 40]
    posts = {(i, j): sp.csr_matrix(np.full((lengths[i], lengths[j]), 0.02,
                                           np.float32))
             for i, j in ((0, 1), (0, 2), (1, 2))}
    got = tsector.relax_sector_device(posts, lengths, reps=1, device="cpu")
    want = jsector.relax_sector_device(posts, lengths, reps=1)
    for key in ((0, 1), (0, 2)):
        g, w = got[key].tocoo(), want[key].tocoo()
        assert sorted(g.col) == sorted(w.col) == list(range(24))
    _close(got, want)


def test_sector_plan_over_budget_raises():
    with pytest.raises(tsector.SectorOverBudget):
        tsector.SectorRelaxer([400] * 20, budget=1 << 20, device="cpu")


@pytest.fixture
def forced_sectors(monkeypatch):
    """Both packages over their dense tensor's budget, with a sector
    budget of several pair blocks."""
    small = 6 * 128 * 128 * 8 * 3
    monkeypatch.setattr(jpw, "_CONS_BUDGET", 1 << 10)
    monkeypatch.setattr(jconfig.DEFAULT.engine, "sector_budget_bytes", small)
    budgets = (1 << 40, 1 << 10, small)
    monkeypatch.setattr(tpw, "engine_budgets", lambda *a: budgets)
    monkeypatch.setattr(tsector, "engine_budgets", lambda *a: budgets)


@pytest.mark.parametrize("config", ["pnp", "quickprobs"])
def test_aligners_over_budget_take_sectors_as_jax(jax_wavefront,
                                                  forced_sectors, config):
    records = synthetic_family(6, 30, 70, 0.3, 0.1, 3)
    want_report, report = {}, {}
    want = jal.align_family(records, config=config, report=want_report)
    got = tal.align_family(records, config=config, report=report,
                           device="cpu")
    assert want_report["consistency_engine"] == "sector"
    assert report["consistency_engine"] == "sector"
    assert report["consistency_downgrade"].startswith("over_budget")
    assert report["sector"]["blocks"] >= 2
    assert got.content_hash() == want.content_hash()


def test_sector_plan_over_its_budget_demotes_to_host(forced_sectors,
                                                      monkeypatch):
    """A plan that cannot fit takes the host relaxation, recorded."""
    monkeypatch.setattr(tsector, "engine_budgets",
                        lambda *a: (1 << 40, 1 << 10, 1 << 10))
    records = synthetic_family(5, 30, 60, 0.3, 0.1, 4)
    report = {}
    msa = tal.align_family(records, report=report, device="cpu")
    assert report["consistency_engine"] == "host"
    assert report["consistency_downgrade"].startswith("oom_sector")
    rows = dict(msa.to_records())
    assert all(rows[h].replace("-", "") == s for h, s in records)
