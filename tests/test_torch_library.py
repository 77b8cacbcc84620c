"""The port's library functions outside the main path against the JAX
package, on the same seeded inputs (CPU on both sides): EM training
(ops/em.py), the classic aligners (ops/classic.py), the local qpx
posterior, the tensor column scores, the realigner's column-score and
entropy helpers, the all-pairs Viterbi and the model parameter dicts.

Tolerances: EM rtol 1e-4 / atol 1e-6 (the row scans compose their maps
in other trees, tests/test_torch_rowscan.py); the classic aligners and
the host helpers exactly; the column scores atol 1e-6; the parameter
dicts, the Viterbi end states and paths exactly.  The local qpx
posterior: atol 1e-5 with rtol 1e-3, and the same zero cells.  Its
log-domain planes carry, as tests/test_torch_qpx.py says, XLA's fused
multiply-adds, and each posterior is the exponential of a difference of
log values of tens to hundreds, where one f32 step is up to ~1e-5: the
posteriors above 1e-4 differ by up to 6e-4 relative, the smaller ones
by more, while no posterior is 4e-6 off in absolute terms.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu.align import refine_qp as jrq  # noqa: E402
from mlprobs_tpu.align import traceback as jtb  # noqa: E402
from mlprobs_tpu.core.msa import MSA as JMSA  # noqa: E402
from mlprobs_tpu.models import params as jmp  # noqa: E402
from mlprobs_tpu.ops import classic as jcl  # noqa: E402
from mlprobs_tpu.ops import colscore as jcs  # noqa: E402
from mlprobs_tpu.ops import em as jem  # noqa: E402
from mlprobs_tpu.ops import qpx as jq  # noqa: E402
from mlprobs_tpu_torch.align import pairwise as tpw  # noqa: E402
from mlprobs_tpu_torch.align import refine_qp as trq  # noqa: E402
from mlprobs_tpu_torch.align import traceback as ttb  # noqa: E402
from mlprobs_tpu_torch.core.alphabet import encode  # noqa: E402
from mlprobs_tpu_torch.core.msa import MSA as TMSA  # noqa: E402
from mlprobs_tpu_torch.ops import classic as tcl  # noqa: E402
from mlprobs_tpu_torch.ops import colscore as tcs  # noqa: E402
from mlprobs_tpu_torch.ops import em as tem  # noqa: E402
from mlprobs_tpu_torch.ops import qpx as tq  # noqa: E402
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


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("name,args", [
    ("hmm5_dict", ()), ("local_dict", ()), ("local_dict", (0.17,)),
    ("partition_dict", ()), ("partition_qp_dict", ()),
])
def test_param_dicts_match_jax(name, args):
    """One dict feeds both packages: the same keys, the same f32 values."""
    want = _np(getattr(jpw, name)(*args))
    got = getattr(tpw, name)(*args, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("train_emissions", [False, True])
@pytest.mark.parametrize("lx,ly,seed", [(23, 17, 0), (9, 31, 1), (1, 4, 2)])
def test_hmm5_em_step_matches_jax(lx, ly, seed, train_emissions):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 20, lx).astype(np.int8)
    y = rng.integers(0, 20, ly).astype(np.int8)
    p = tpw.hmm5_dict("cpu")
    want = jem.hmm5_em_step(jnp.asarray(x), jnp.asarray(y),
                            {k: jnp.asarray(v.numpy()) for k, v in p.items()},
                            train_emissions=train_emissions)
    got = tem.hmm5_em_step(torch.from_numpy(x), torch.from_numpy(y), p,
                           train_emissions=train_emissions)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.fixture
def subs():
    return np.asarray(jmp.blosum62(), dtype=np.int64)


@pytest.mark.parametrize("seed", range(4))
def test_classic_aligners_match_jax(seed, subs):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 20, rng.integers(5, 40))
    y = rng.integers(0, 20, rng.integers(5, 40))
    for gi, ge in ((-11, -1), (-4, -2)):
        assert (tcl.smith_waterman(x, y, subs, gi, ge)
                == jcl.smith_waterman(x, y, subs, gi, ge))
        assert (tcl.needleman_wunsch(x, y, subs, gi, ge)
                == jcl.needleman_wunsch(x, y, subs, gi, ge))
        assert tcl.sw_align(x, y, subs, gi, ge) == jcl.sw_align(
            x, y, subs, gi, ge)


def test_local_posterior_qpx_matches_jax():
    """Lp = 128, B = 4, lengths from 1 to Lp on both sides."""
    rng = np.random.default_rng(0)
    b, lp = 4, 128
    lx = np.array([128, 90, 33, 1], np.int32)
    ly = np.array([100, 128, 60, 5], np.int32)
    X = np.full((b, lp), 20, np.int8)
    Y = np.full((b, lp), 20, np.int8)
    for k in range(b):
        X[k, : lx[k]] = rng.integers(0, 20, lx[k])
        Y[k, : ly[k]] = rng.integers(0, 20, ly[k])
    p = tpw.local_dict(0.17, device="cpu")
    args = (p["trans"], p["log_stay"], p["lmatch"], p["lins"])
    want = np.asarray(jq.local_posterior_qpx(
        *map(jnp.asarray, (X, Y, lx, ly)),
        *(jnp.asarray(a.numpy()) for a in args)))
    got = tq.local_posterior_qpx(*map(torch.from_numpy, (X, Y, lx, ly)),
                                 *args).numpy()
    assert got.shape == want.shape == (2 * lp + 1, b, lp + 1)
    assert got.dtype == np.float32
    # the posteriors reach 0.8 and differ by at most ~4e-6: held at that
    # scale, with the same cells zero on both sides
    assert want.max() > 100 * 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(got == 0, want == 0)


def _gapped_rows(seed, n=7, length=60):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 21, (n, length)).astype(np.int8)
    rows[rng.random((n, length)) < 0.3] = -1
    rows[:, :3] = -1          # terminal gaps
    rows[0, -5:] = -1
    return rows


@pytest.mark.parametrize("seed", range(3))
def test_column_scores_torch_matches_jax_and_numpy(seed):
    rows = _gapped_rows(seed)
    got = tcs.column_scores_torch(torch.from_numpy(rows))
    assert got.dtype == torch.float32 and got.shape == (rows.shape[1],)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jcs.column_scores_jnp(jnp.asarray(rows))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), tcs.column_scores(rows),
                               rtol=0, atol=1e-6)


def _msas(seed):
    recs = synthetic_family(6, 30, 50, sub=0.4, indel=0.2, seed=seed)
    width = max(len(s) for _, s in recs) + 8
    rng = np.random.default_rng(seed)
    aligned = []
    for h, s in recs:
        pos = np.sort(rng.choice(width, len(s), replace=False))
        row = np.array(["-"] * width)
        row[pos] = list(s)
        aligned.append((h, "".join(row)))
    return JMSA.from_records(aligned), TMSA.from_records(aligned)


@pytest.mark.parametrize("seed", range(3))
def test_column_score_and_entropy_helpers_match_jax(seed):
    jm, tm = _msas(seed)
    for ign in (True, False):
        assert (trq.update_column_scores(tm, ignore_terminal_gaps=ign)
                == jrq.update_column_scores(jm, ignore_terminal_gaps=ign))
    assert trq.entropy_score(tm) == jrq.entropy_score(jm)


def test_all_pairs_viterbi_matches_jax(monkeypatch):
    """The JAX package's row-scan route (engine "scan"), the port's
    `viterbi_batches` counterpart: end states and traced paths exactly,
    as tests/test_torch_rowscan.py holds `viterbi_local` (a direction
    bit of a cell off the path may differ where two scores tie to
    within the scans' rounding)."""
    recs = synthetic_family(4, 30, 70, sub=0.5, indel=0.1, seed=3)
    seqs = [encode(s) for _, s in recs]
    monkeypatch.setenv("MLPROBS_POSTERIOR_ENGINE", "scan")
    jpw._reset_engine_caches()
    try:
        want = list(jpw.all_pairs_viterbi(seqs))
    finally:
        monkeypatch.undo()
        jpw._reset_engine_caches()
    got = list(tpw.all_pairs_viterbi(seqs, device="cpu"))
    assert [k for k, _, _ in got] == [k for k, _, _ in want]
    for ((i, j), gd, ge), (_, wd, we) in zip(got, want):
        a, b = len(seqs[i]), len(seqs[j])
        assert gd.shape == (a + 1, b + 1) and gd.dtype == np.int8
        assert ge == we
        np.testing.assert_array_equal(
            ttb.viterbi_traceback(gd, ge, a, b),
            jtb.viterbi_traceback(np.asarray(wd), we, a, b))
