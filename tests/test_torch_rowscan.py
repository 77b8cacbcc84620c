"""The port's row-scan library (ops/semiring.py, ops/pairhmm.py,
ops/partition.py, ops/mwt.py, ops/viterbi.py, align/traceback.py) and its
`scan` posterior engine against the JAX package, on the same seeded
inputs (CPU on both sides; the JAX functions batched with jax.vmap).

Tolerances: the semiring scans rtol 1e-5 (the port composes the affine
maps in a Hillis-Steele tree, the JAX package with
lax.associative_scan); posteriors, planes and totals rtol 1e-4 and
atol 1e-5; MWT directions and match counts exact, scores rtol 1e-5;
Viterbi paths and end states exact.  The brute-force oracles of
tests/oracle.py check the posteriors a second time, to the JAX package's
own 2e-4.  The scan engine's CSRs are compared as
tests/test_torch_align.py compares the wavefront engine's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu.align import traceback as jtb  # noqa: E402
from mlprobs_tpu.ops import mwt as jmwt  # noqa: E402
from mlprobs_tpu.ops import pairhmm as jph  # noqa: E402
from mlprobs_tpu.ops import partition as jpart  # noqa: E402
from mlprobs_tpu.ops import semiring as jsr  # noqa: E402
from mlprobs_tpu.ops import viterbi as jvit  # noqa: E402
from mlprobs_tpu_torch.align import aligner as tal  # noqa: E402
from mlprobs_tpu_torch.align import pairwise as tpw  # noqa: E402
from mlprobs_tpu_torch.align import traceback as ttb  # noqa: E402
from mlprobs_tpu_torch.core.alphabet import encode  # noqa: E402
from mlprobs_tpu_torch.ops import mwt as tmwt  # noqa: E402
from mlprobs_tpu_torch.ops import pairhmm as tph  # noqa: E402
from mlprobs_tpu_torch.ops import partition as tpart  # noqa: E402
from mlprobs_tpu_torch.ops import semiring as tsr  # noqa: E402
from mlprobs_tpu_torch.ops import viterbi as tvit  # noqa: E402
from mlprobs_tpu_torch.utils.synth import synthetic_family  # noqa: E402

from tests import oracle  # noqa: E402

LEAVE = 0.170705
LP = 48
# true lengths of the batch's pairs: 1 up to Lp, both sides
LENS = ((1, 1), (1, 7), (9, 1), (17, 30), (48, 48), (33, 48), (48, 20),
        (2, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain PyTorch loops: their tensors are
    small, and parallel test workers with a thread pool each would
    oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, lens=LENS, lp=LP):
    rng = np.random.default_rng(seed)
    X = np.full((len(lens), lp), 20, np.int8)
    Y = np.full((len(lens), lp), 20, np.int8)
    for k, (a, b) in enumerate(lens):
        X[k, :a] = rng.integers(0, 20, a)
        Y[k, :b] = rng.integers(0, 20, b)
    LX = np.array([a for a, _ in lens], np.int32)
    LY = np.array([b for _, b in lens], np.int32)
    return X, Y, LX, LY


def _tables(mode="mix"):
    """Numpy log tables of each model, as the JAX package's dicts hold
    them (`pairwise.hmm5_dict`, `local_dict`, `partition_dict`)."""
    h5 = {k: np.asarray(v) for k, v in jpw.hmm5_dict().items()}
    lo = {k: np.asarray(v) for k, v in jpw.local_dict(LEAVE).items()}
    pt = {k: np.asarray(v) for k, v in (
        jpw.partition_qp_dict() if mode == "qp"
        else jpw.partition_dict()).items()}
    return {"hmm5": h5, "local": lo, "partition": pt}


def _jax(fn, X, Y, LX, LY, p):
    out = jax.vmap(fn, in_axes=(0, 0, 0, 0, None))(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(LX), jnp.asarray(LY),
        {k: jnp.asarray(v) for k, v in p.items()})
    return jax.tree_util.tree_map(np.asarray, out)


def _torch(fn, X, Y, LX, LY, p):
    out = fn(*(torch.from_numpy(a) for a in (X, Y, LX, LY)),
             {k: torch.tensor(v) for k, v in p.items()})
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _valid_grid(LX, LY, shape):
    """(B, Lx+1, Ly+1) mask of the grid cells inside each pair."""
    i = np.arange(shape[1])[None, :, None]
    j = np.arange(shape[2])[None, None, :]
    return (i <= LX[:, None, None]) & (j <= LY[:, None, None])


# ---------------------------------------------------------------- semiring


@pytest.mark.parametrize("kind", ["log", "max"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
def test_semiring_scans_match_jax(kind, reverse, with_init):
    rng = np.random.default_rng(4 * (kind == "max") + 2 * reverse
                                + with_init)
    c = rng.normal(-5.0, 3.0, (4, 37)).astype(np.float32)
    d = rng.normal(-1.0, 0.5, (4, 37)).astype(np.float32)
    c[rng.random(c.shape) < 0.2] = tsr.LOG_ZERO
    d[:, 5] = tsr.LOG_ZERO
    init = np.float32(-2.5) if with_init else None
    jf = jsr.affine_scan_log if kind == "log" else jsr.affine_scan_max
    tf = tsr.affine_scan_log if kind == "log" else tsr.affine_scan_max
    want = np.asarray(jf(jnp.asarray(c), jnp.asarray(d), init=init,
                         reverse=reverse))
    got = tf(torch.from_numpy(c), torch.from_numpy(d), init=init,
             reverse=reverse).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # along another dim, as a transposed problem
    got_t = tf(torch.from_numpy(c.T.copy()), torch.from_numpy(d.T.copy()),
               init=init, reverse=reverse, dim=0).numpy()
    np.testing.assert_allclose(got_t.T, want, rtol=1e-5)


def test_semiring_helpers_match_jax():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, 9)).astype(np.float32)
    b = rng.normal(size=(3, 9)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for jf, tf in ((jsr.shift_right, tsr.shift_right),
                   (jsr.shift_left, tsr.shift_left)):
        assert np.array_equal(tf(ta).numpy(), np.asarray(jf(jnp.asarray(a))))
        assert np.array_equal(tf(ta, 0.0).numpy(),
                              np.asarray(jf(jnp.asarray(a), 0.0)))
    np.testing.assert_allclose(tsr.logaddexp(ta, tb).numpy(),
                               np.asarray(jsr.logaddexp(a, b)), rtol=1e-6)
    np.testing.assert_allclose(tsr.logsumexp(ta).numpy(),
                               np.asarray(jsr.logsumexp(a)), rtol=1e-6)
    np.testing.assert_allclose(tsr.logsumexp(ta, dim=1).numpy(),
                               np.asarray(jsr.logsumexp(a, axis=1)),
                               rtol=1e-6)
    assert np.float32(tsr.LOG_ZERO) == np.float32(jsr.LOG_ZERO)


# ------------------------------------------------------------ pair models


def test_hmm5_forward_backward_posterior_match_jax():
    X, Y, LX, LY = _batch(seed=1)
    p = _tables()["hmm5"]
    jf, js = _jax(jph.hmm5_forward, X, Y, LX, LY, p)
    tf, ts = _torch(tph.hmm5_forward, X, Y, LX, LY, p)
    ok = _valid_grid(LX, LY, jf.shape)
    np.testing.assert_allclose(tf[ok], jf[ok], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-5)
    jb, jst = _jax(jph.hmm5_backward, X, Y, LX, LY, p)
    tb, tst = _torch(tph.hmm5_backward, X, Y, LX, LY, p)
    np.testing.assert_allclose(tb[ok], jb[ok], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tst, jst, rtol=1e-4, atol=1e-5)
    want = _jax(jph.hmm5_posterior, X, Y, LX, LY, p)
    got = _torch(tph.hmm5_posterior, X, Y, LX, LY, p)
    assert got.shape == want.shape == (len(LENS), LP, LP)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_local_forward_backward_posterior_match_jax():
    X, Y, LX, LY = _batch(seed=2)
    p = _tables()["local"]
    for jfn, tfn in ((jph.local_forward, tph.local_forward),
                     (jph.local_backward, tph.local_backward)):
        jpl, jt = _jax(jfn, X, Y, LX, LY, p)
        tpl, tt = _torch(tfn, X, Y, LX, LY, p)
        ok = _valid_grid(LX, LY, jpl.shape)
        np.testing.assert_allclose(tpl[ok], jpl[ok], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tt, jt, rtol=1e-4, atol=1e-5)
    want = _jax(jph.local_posterior, X, Y, LX, LY, p)
    got = _torch(tph.local_posterior, X, Y, LX, LY, p)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["mix", "qp"])
def test_partition_posterior_matches_jax(mode):
    X, Y, LX, LY = _batch(seed=3)
    p = _tables(mode)["partition"]
    jz, jt = _jax(jpart._partition_forward, X, Y, LX, LY, p)
    tz, tt = _torch(tpart._partition_forward, X, Y, LX, LY, p)
    ok = _valid_grid(LX, LY, jz.shape)
    np.testing.assert_allclose(tz[ok], jz[ok], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tt, jt, rtol=1e-4, atol=1e-5)
    want = _jax(jpart.partition_posterior, X, Y, LX, LY, p)
    got = _torch(tpart.partition_posterior, X, Y, LX, LY, p)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


ORACLES = {
    "hmm5": (tph.hmm5_posterior, oracle.hmm5_posterior_oracle),
    "local": (tph.local_posterior, oracle.local_posterior_oracle),
    "partition": (tpart.partition_posterior,
                  oracle.partition_posterior_oracle),
}


@pytest.mark.parametrize("model", sorted(ORACLES))
def test_posteriors_match_brute_force_oracle(model):
    lens = ((7, 9), (12, 5), (1, 1), (2, 6))
    X, Y, LX, LY = _batch(seed=4, lens=lens, lp=12)
    p = _tables()[model]
    got = _torch(ORACLES[model][0], X, Y, LX, LY, p)
    p64 = {k: np.asarray(v, np.float64) for k, v in p.items()}
    for k, (a, b) in enumerate(lens):
        want, _ = ORACLES[model][1](X[k, :a].astype(np.int64),
                                    Y[k, :b].astype(np.int64), p64)
        np.testing.assert_allclose(got[k, :a, :b], want, atol=2e-4)
        assert np.all(got[k, a:] == 0) and np.all(got[k, :, b:] == 0)


def test_float64_scans_match_the_kernels_plain_versions_at_full_length():
    """The `scan` engine's arithmetic (the row scans in float64) against
    the plain versions of the CUDA kernels (the wavefront engine) on one
    pair of chip_smoke.py's smoke family (436 x 424 residues, Lp = 512):
    the mix RMS posterior within rtol 2e-3 / atol 2e-5, the JAX package's
    tolerance between the two formulations, as chip_smoke.py's [scan]
    holds it on the card."""
    from mlprobs_tpu_torch.core.alphabet import degap
    from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as twk

    recs = synthetic_family(48, 330, 470, sub=0.5, indel=0.1, seed=48)
    seqs = [degap(encode(s)) for _, s in recs]
    dev = torch.device("cpu")
    (_, X, Y, LX, LY), = list(tpw.iter_pair_batches(seqs, [(0, 1)], dev,
                                                    force_lp=512))
    params = tpw._scan_params("mix", LEAVE, dev, torch.float64)
    posts = [tpw._SCAN_MODELS[m](X, Y, LX, LY, params[m]).float()
             for m in ("hmm5", "partition", "local")]
    scan = torch.sqrt(sum(p * p for p in posts) / 3)
    tf, tr = tpw._wf_tables("mix", LEAVE, dev)
    post, _ = twk.posterior(X, Y, LX, LY, tf, tr,
                            models=("hmm5", "partition", "local"))
    kern = twk.wf.unskew_posterior(post)
    torch.testing.assert_close(scan, kern, rtol=2e-3, atol=2e-5)


# -------------------------------------------------------- MWT and Viterbi


def test_mwt_align_and_count_matches_match_jax():
    X, Y, LX, LY = _batch(seed=6)
    post = _jax(jph.hmm5_posterior, X, Y, LX, LY, _tables()["hmm5"])
    jd, js = jax.vmap(jmwt.mwt_align)(jnp.asarray(post), jnp.asarray(LX),
                                      jnp.asarray(LY))
    jn = jax.vmap(jmwt.count_matches)(jd, jnp.asarray(LX), jnp.asarray(LY))
    td, ts = tmwt.mwt_align(torch.tensor(post), torch.from_numpy(LX),
                            torch.from_numpy(LY))
    tn = tmwt.count_matches(td, torch.from_numpy(LX), torch.from_numpy(LY))
    assert td.dtype == torch.int8 and tn.dtype == torch.int32
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    assert np.array_equal(tn.numpy(), np.asarray(jn))


def test_viterbi_local_and_traceback_match_jax():
    X, Y, LX, LY = _batch(seed=7)
    p = {k: v for k, v in _tables()["local"].items() if k != "log_stay"}
    jd, je, js = _jax(jvit.viterbi_local, X, Y, LX, LY, p)
    td, te, ts = _torch(tvit.viterbi_local, X, Y, LX, LY, p)
    assert np.array_equal(te, je)
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    assert np.array_equal(tvit.VIT_INIT, jvit.VIT_INIT)
    for k, (a, b) in enumerate(LENS):
        want = jtb.viterbi_traceback(jd[k], int(je[k]), a, b)
        got = ttb.viterbi_traceback(td[k], int(te[k]), a, b)
        assert got.dtype == np.int8
        assert np.array_equal(got, want)
        assert int((got != 1).sum()) == b and int((got != 2).sum()) == a


# ------------------------------------------------------ the scan engine


@pytest.fixture
def scan_engine(monkeypatch):
    """Both packages on their row-scan engines."""
    monkeypatch.setenv("MLPROBS_POSTERIOR_ENGINE", "scan")
    jpw._reset_engine_caches()
    yield
    monkeypatch.undo()
    jpw._reset_engine_caches()


@pytest.mark.parametrize("mode", ["mix", "qp"])
def test_scan_engine_csrs_match_jax(scan_engine, mode):
    recs = synthetic_family(5, 20, 40, sub=0.4, indel=0.1, seed=21)
    seqs = [encode(s) for _, s in recs]

    def collect(mod, **kw):
        return {(i, j): (csr.toarray(), score, nb)
                for (i, j), csr, score, nb in mod.all_pairs_posteriors(
                    seqs, mode=mode, leave_prob=LEAVE, with_matches=True,
                    **kw)}

    want = collect(jpw)
    got = collect(tpw, device="cpu")
    assert want.keys() == got.keys() and len(got) == 10
    for k in want:
        aw, sw, nw = want[k]
        ag, sg, ng = got[k]
        assert nw == ng
        np.testing.assert_allclose(sg, sw, rtol=1e-4, atol=1e-3)
        both = (aw > 0) == (ag > 0)
        assert np.abs(ag - aw)[both].max(initial=0.0) <= 2e-4
        assert np.all(np.abs((ag + aw)[~both] - 0.01) <= 2e-4)


def test_scan_engine_takes_the_host_consistency(scan_engine):
    recs = synthetic_family(5, 20, 40, sub=0.4, indel=0.1, seed=22)
    seqs = [encode(s) for _, s in recs]
    report: dict = {}
    assert tpw.device_posterior_tensor(seqs, "mix", LEAVE, report=report,
                                       device="cpu") is None
    assert report["consistency_downgrade"] == "engine:scan"
    jrep: dict = {}
    assert jpw.device_posterior_tensor(seqs, "mix", LEAVE,
                                       report=jrep) is None
    assert jrep == report
    areport: dict = {}
    msa = tal.align_family(recs, report=areport, device="cpu")
    assert areport["posterior_engine"] == "row-scan"
    assert areport["consistency_engine"] == "host"
    rows = dict(msa.to_records())
    assert all(rows[h].replace("-", "") == s for h, s in recs)


def test_scan_engine_feature_pass_matches_jax(scan_engine, monkeypatch):
    """Under `scan` the feature pass is the row-scan Viterbi with a host
    traceback on both sides (the JAX package's pure-Python statistics,
    its native helper patched out): equal FamilyStats."""
    import dataclasses

    from mlprobs_tpu.align import aligner as jal
    from mlprobs_tpu.utils import native as jnative

    monkeypatch.setattr(jnative, "viterbi_features_batch",
                        lambda *a, **kw: None)
    recs = synthetic_family(6, 20, 50, sub=0.4, indel=0.1, seed=23)
    seqs = [encode(s) for _, s in recs]
    want = jal.family_viterbi_stats(seqs, with_features=True)
    got = tal.family_viterbi_stats(seqs, with_features=True, device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("engine", ["native", "wavefront", "cuda"])
def test_unknown_engine_raises(monkeypatch, engine):
    monkeypatch.setenv("MLPROBS_POSTERIOR_ENGINE", engine)
    seqs = [encode("ACDEFGHIK"), encode("ACDFGHIK")]
    with pytest.raises(ValueError, match="pallas"):
        list(tpw.all_pairs_posteriors(seqs, "mix", LEAVE, device="cpu"))
    with pytest.raises(ValueError, match="scan"):
        tal.align_family([("a", "ACDEFGHIK"), ("b", "ACDFGHIK"),
                          ("c", "ACDEFGK")], device="cpu")
