"""The qp route's MWT and top-k (`wavefront_kernel.mwt_topk`, combine's
GIVEN kind on the card) against the plain `topk_skew` + `mwt_skew` and
against the JAX package's `_qp_exact_fn` / `_qp_exact_dense_fn`, on the
CPU on both sides.

Tolerances.  The JAX package jits the qp functions, and XLA's CPU backend
contracts the qpx polynomials into fused multiply-adds
(tests/test_torch_qpx.py), so the two posterior planes differ in the last
bits: top-k values atol 2e-4 (the posterior plane tolerance), lanes equal
wherever the value is positive, the MWT score rtol 1e-4 / atol 1e-3, the
match counts exact.  On one side the wrapper is its plain version bit for
bit.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu_torch.align import pairwise as tpw  # noqa: E402
from mlprobs_tpu_torch.ops import wavefront as twf  # noqa: E402
from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as twk  # noqa: E402

LP, B = 128, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: small tensors, several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(b, lp, seed):
    """A related pair batch (40 % substitutions of one ancestor), ragged:
    the first x of full length, the last y."""
    rng = np.random.default_rng(seed)
    X = np.full((b, lp), 20, np.int8)
    Y = np.full((b, lp), 20, np.int8)
    lx = rng.integers(lp // 2, lp + 1, b).astype(np.int32)
    ly = rng.integers(lp // 2, lp + 1, b).astype(np.int32)
    lx[0] = ly[-1] = lp
    anc = rng.integers(0, 20, lp)
    for k in range(b):
        X[k, :lx[k]] = np.where(rng.random(lx[k]) < 0.4,
                                rng.integers(0, 20, lx[k]), anc[:lx[k]])
        Y[k, :ly[k]] = np.where(rng.random(ly[k]) < 0.4,
                                rng.integers(0, 20, ly[k]), anc[:ly[k]])
    return X, Y, lx, ly


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plane(seed, lp=40, b=3):
    """A posterior-like (D, B, W) plane: sparse values in [0, 1] with
    exact ties along each diagonal, noise past each pair's extent and in
    lane 0, and its lengths."""
    rng = np.random.default_rng(seed)
    d, w = 2 * lp + 1, lp + 1
    p = np.where(rng.random((d, b, w)) < 0.3,
                 rng.random((d, b, w)), 0.0).astype(np.float32)
    p[:, :, 5:9] = 0.25                     # ties along every diagonal
    p[:, :, 0] = rng.random((d, b))         # lane 0 ranked too
    lx = rng.integers(lp // 2, lp + 1, b).astype(np.int32)
    ly = rng.integers(lp // 2, lp + 1, b).astype(np.int32)
    return _t(p), _t(lx), _t(ly)


@pytest.mark.parametrize("topk", [0, 1, 16])
@pytest.mark.parametrize("with_matches", [False, True])
def test_mwt_topk_on_cpu_is_the_plain_tail(topk, with_matches):
    """On a CPU tensor `mwt_topk` is `topk_skew` + `mwt_skew`, bit for
    bit, and launches nothing."""
    post, lx, ly = _plane(3 + topk)
    n = twk.combine.launches
    got = twk.mwt_topk(post, lx, ly, with_matches=with_matches, topk=topk,
                       cutoff=0.01)
    mw = twf.mwt_skew(post, lx, ly, with_matches=with_matches)
    want = ((twf.topk_skew(post, topk, 0.01) if topk else ())
            + (mw if with_matches else (mw,)))
    assert len(got) == len(want) == (2 if topk else 0) + 1 + with_matches
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert twk.combine.launches == n


@pytest.mark.parametrize("fault", ["dtype", "shape", "lengths", "device",
                                   "topk_over_w", "topk_negative"])
def test_mwt_topk_rejects_arguments_the_kernel_does_not_take(monkeypatch,
                                                             fault):
    """With a kernel library at hand, `mwt_topk` checks its arguments
    before it launches: one the GIVEN kind does not take raises
    KernelArgumentError, and nothing is launched or counted."""
    from mlprobs_tpu_torch.ops.kernels import build

    class NoLaunch:
        def combine_launch(self, *a):
            raise AssertionError("launched with an argument it cannot take")

    monkeypatch.setattr(build, "lib", lambda name: NoLaunch())
    meta, lp, b = torch.device("meta"), 64, 2
    f32 = functools.partial(torch.empty, dtype=torch.float32, device=meta)
    i32 = functools.partial(torch.empty, dtype=torch.int32, device=meta)
    post, lx, ly, kw = f32((2 * lp + 1, b, lp + 1)), i32((b,)), i32((b,)), {}
    if fault == "dtype":
        post = torch.empty(post.shape, dtype=torch.float64, device=meta)
    elif fault == "shape":
        post = f32((2 * lp, b, lp + 1))
    elif fault == "lengths":
        ly = i32((b + 1,))
    elif fault == "device":
        lx = torch.zeros((b,), dtype=torch.int32)
    elif fault == "topk_over_w":
        kw["topk"] = lp + 2
    else:
        kw["topk"] = -1
    launches = twk.combine.launches
    with pytest.raises(build.KernelArgumentError):
        twk.mwt_topk(post, lx, ly, with_matches=True, **kw)
    assert twk.combine.launches == launches


def _port_fn(with_matches):
    tables = functools.partial(tpw._wf_tables, "qp", None)
    if with_matches is None:
        return tpw._qp_exact_dense_fn(tables)
    return tpw._qp_exact_fn(with_matches, tables)


@pytest.mark.parametrize("with_matches", [False, True])
def test_qp_exact_fn_matches_jax(with_matches):
    """The qp route's top-k, score and match counts against the JAX
    package's `_qp_exact_fn` on the same batch."""
    X, Y, lx, ly = _batch(B, LP, seed=50 + with_matches)
    jf, jr = jpw._wf_tables("qp", None)
    want = [np.asarray(o) for o in jpw._qp_exact_fn(with_matches)(
        *(jnp.asarray(a) for a in (X, Y, lx, ly)), jf, jr)]
    got = [o.numpy() for o in _port_fn(with_matches)(
        *(_t(a) for a in (X, Y, lx, ly)))]
    assert len(got) == len(want) == 3 + with_matches
    vals, lanes = got[:2]
    assert vals.shape == want[0].shape == (2 * LP + 1, B, tpw.TOPK)
    np.testing.assert_allclose(vals, want[0], rtol=0, atol=2e-4)
    pos = want[0] > 0
    assert np.array_equal(lanes[pos], want[1][pos])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-3)
    if with_matches:
        assert np.array_equal(got[3], want[3])


def test_qp_exact_dense_fn_matches_jax():
    """The dense qp route (the consistency tensor's): the thresholded grid
    plane and the MWT score against the JAX package's."""
    X, Y, lx, ly = _batch(B, LP, seed=60)
    jf, jr = jpw._wf_tables("qp", None)
    wd, ws = (np.asarray(o) for o in jpw._qp_exact_dense_fn()(
        *(jnp.asarray(a) for a in (X, Y, lx, ly)), jf, jr))
    gd, gs = (o.numpy() for o in _port_fn(None)(
        *(_t(a) for a in (X, Y, lx, ly))))
    assert gd.shape == wd.shape == (B, LP, LP)
    np.testing.assert_allclose(gd, wd, rtol=0, atol=2e-4)
    np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-3)


def test_qp_plane_lane_zero_is_exactly_zero():
    """Lane 0 of every row of the qp plane is 0: the qpx posterior masks
    lane >= 1 and the partition posterior has no mass on column 0, so
    ranking lane 0 (as `topk_skew` and the GIVEN kind do) adds no entry."""
    X, Y, lx, ly = _batch(B, LP, seed=70)
    tf, tr = tpw._wf_tables("qp", None, "cpu")
    post = tpw._qpx_combined_skew(*(_t(a) for a in (X, Y, lx, ly)), tf, tr)
    assert post.shape == (2 * LP + 1, B, LP + 1)
    assert bool((post[:, :, 0] == 0).all())
    assert float(post[:, :, 1:].max()) > 0.5    # the plane is not empty
