"""The port's QuickProbs-exact HMM5 (ops/qpx.py) and the realigner's
combined posterior against the JAX package, on the CPU on both sides.

Tolerances.  The polynomial helpers equal the JAX package's eager
(op-by-op) results bit for bit; EXP's x > 0 branch is the library exp,
where XLA's and PyTorch's may differ by one ulp.  Inside `jit`, XLA's CPU
backend contracts each polynomial's multiply-add into a fused
multiply-add (`test_jit_contracts_the_polynomial_to_fma` shows it), while
the port rounds every multiply and add on its own, as the reference
source is written.  So the forward/backward planes differ in the last
bits: the LOG_ZERO pattern is equal, finite entries and totals agree to
rtol 1e-5, posteriors to 2e-4 (ROADMAP's plane tolerance).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu.models import params as jmp  # noqa: E402
from mlprobs_tpu.ops import qpx as jq  # noqa: E402
from mlprobs_tpu_torch.align import pairwise as tpw  # noqa: E402
from mlprobs_tpu_torch.ops import qpx as tq  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain PyTorch loops: their tensors are
    small, and parallel test workers with a thread pool each would
    oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_POINTS = 100_000


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def test_lookup_float_and_log_add_match_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 9.0, N_POINTS).astype(np.float32)
    want = jq.lookup_float(jnp.asarray(x))
    assert np.array_equal(_bits(want), _bits(tq.lookup_float(_t(x))))
    u = rng.uniform(-60.0, 0.0, N_POINTS).astype(np.float32)
    v = rng.uniform(-60.0, 0.0, N_POINTS).astype(np.float32)
    v[::7] = jq.LOG_ZERO
    u[::11] = jq.LOG_ZERO
    want = jq.log_add(jnp.asarray(u), jnp.asarray(v))
    assert np.array_equal(_bits(want), _bits(tq.log_add(_t(u), _t(v))))


def test_exp_ref_matches_jax():
    """Bit for bit on [-20, 0]; one ulp at most above 0 (library exp)."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-20.0, 2.0, N_POINTS).astype(np.float32)
    x[:8] = [-16.0, -8.0, -4.0, -2.0, -1.0, -0.5, 0.0, -0.0]
    want = _bits(jq.exp_ref(jnp.asarray(x)))
    got = _bits(tq.exp_ref(_t(x)))
    neg = x <= 0
    assert np.array_equal(want[neg], got[neg])
    assert np.abs(want[~neg].astype(np.int64) - got[~neg]).max() <= 1


def test_log_zero_cases():
    """The LOG_ZERO cases of tests/test_qpx.py."""
    lz = torch.tensor(tq.LOG_ZERO)
    v = torch.tensor(-3.25)
    assert float(tq.log_add(v, lz)) == -3.25
    assert float(tq.log_add(lz, v)) == -3.25
    assert float(tq.log_add(lz, lz)) == tq.LOG_ZERO
    assert tq.LOG_ZERO == float(jq.LOG_ZERO)
    assert float(tq.exp_ref(torch.tensor(-17.0))) == 0.0


def test_jit_contracts_the_polynomial_to_fma():
    """Why the planes are compared by tolerance: jitted on the CPU, XLA
    evaluates LOOKUP_FLOAT's cubic with fused multiply-adds, the port
    (like the eager JAX ops) with separately rounded ones."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0.0, 1.0, N_POINTS).astype(np.float32)
    a, b, c, d = (np.float32(v) for v in tq._LOOKUP_COEF[0])

    def fma(p, q, r):      # one rounding: exact in f64 for f32 inputs
        return (np.float64(p) * np.float64(q) + np.float64(r)).astype(
            np.float32)

    fused = fma(fma(fma(a, x, b), x, c), x, d)
    rounded = ((a * x + b) * x + c) * x + d
    assert not np.array_equal(fused, rounded)
    assert np.array_equal(
        np.asarray(jax.jit(jq.lookup_float)(jnp.asarray(x))), fused)
    assert np.array_equal(tq.lookup_float(_t(x)).numpy(), rounded)


def _batch(b, lp, seed):
    rng = np.random.default_rng(seed)
    X = np.full((b, lp), 20, np.int8)
    Y = np.full((b, lp), 20, np.int8)
    lx = rng.integers(lp // 2, lp + 1, b).astype(np.int32)
    ly = rng.integers(lp // 2, lp + 1, b).astype(np.int32)
    lx[0] = lp
    anc = rng.integers(0, 20, lp)
    for k in range(b):
        X[k, :lx[k]] = np.where(rng.random(lx[k]) < 0.4,
                                rng.integers(0, 20, lx[k]), anc[:lx[k]])
        Y[k, :ly[k]] = np.where(rng.random(ly[k]) < 0.4,
                                rng.integers(0, 20, ly[k]), anc[:ly[k]])
    return X, Y, lx, ly


def _p5():
    p5 = jmp.hmm5_params()
    return p5.init, p5.trans, p5.lmatch, p5.lins


@pytest.mark.parametrize("b", [1, 3])
def test_hmm5_fb_qpx_matches_jax(b):
    X, Y, lx, ly = _batch(b, 128, seed=10 + b)
    jf, jb, jt = (np.asarray(o) for o in jq.hmm5_fb_qpx(
        *(jnp.asarray(a) for a in (X, Y, lx, ly) + _p5())))
    tf, tb, tt = (o.numpy() for o in tq.hmm5_fb_qpx(
        *(_t(a) for a in (X, Y, lx, ly) + _p5())))
    for want, got in ((jf, tf), (jb, tb)):
        assert got.shape == want.shape
        zw, zg = want == jq.LOG_ZERO, got == jq.LOG_ZERO
        assert np.array_equal(zw, zg)
        fin = ~zw & np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    np.testing.assert_allclose(tt, jt, rtol=1e-5)


@pytest.mark.parametrize("b", [1, 3])
def test_hmm5_posterior_qpx_matches_jax(b):
    X, Y, lx, ly = _batch(b, 128, seed=20 + b)
    want = np.asarray(jq.hmm5_posterior_qpx(
        *(jnp.asarray(a) for a in (X, Y, lx, ly) + _p5())))
    got = tq.hmm5_posterior_qpx(*(_t(a) for a in (X, Y, lx, ly) + _p5()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("b", [1, 3])
def test_qpx_combined_skew_matches_jax(b):
    X, Y, lx, ly = _batch(b, 128, seed=30 + b)
    jf, jr = jpw._wf_tables("qp", None)
    want = np.asarray(jpw._qpx_combined_skew(
        *(jnp.asarray(a) for a in (X, Y, lx, ly)), jf, jr))
    tf, tr = tpw._wf_tables("qp", None, "cpu")
    got = tpw._qpx_combined_skew(*(_t(a) for a in (X, Y, lx, ly)), tf, tr)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


def test_pairs_are_independent_of_their_batch():
    """The port pads no batch with dummy pairs (the JAX package does):
    a pair's qp posterior is the same alone (B = 1) as in a batch of 3."""
    X, Y, lx, ly = _batch(3, 128, seed=40)
    tf, tr = tpw._wf_tables("qp", None, "cpu")
    full = tpw._qpx_combined_skew(*(_t(a) for a in (X, Y, lx, ly)), tf, tr)
    for k in range(3):
        one = tpw._qpx_combined_skew(
            *(_t(a[k:k + 1]) for a in (X, Y, lx, ly)), tf, tr)
        assert torch.equal(one[:, 0], full[:, k])
