"""The port's plain wavefront engine against the JAX package's.

The same seeded batches go through `mlprobs_tpu.ops.wavefront` (and the
Pallas kernels in interpret mode) and through `mlprobs_tpu_torch`'s plain
PyTorch engine, the CPU path of the two CUDA kernels.  Tolerances:
posterior planes atol 2e-4 (the JAX package's own kernel-vs-scan bound,
tests/test_pallas.py); sweep planes 1e-5 relative to each row's max,
after aligning both to one scale; log2 totals 2e-4; padding
exactly zero; MWT score rtol 1e-4 / atol 1e-3; match counts, Viterbi
directions and feature statistics exact; top-k values 1e-7 with lanes
equal wherever the value is positive.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu.models import params as jmp  # noqa: E402
from mlprobs_tpu.ops import viterbi as jvit  # noqa: E402
from mlprobs_tpu.ops import wavefront as jwf  # noqa: E402
from mlprobs_tpu.ops.pallas import wavefront_kernel as jwk  # noqa: E402
from mlprobs_tpu_torch.align import pairwise as tpw  # noqa: E402
from mlprobs_tpu_torch.ops import wavefront as twf  # noqa: E402
from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as twk  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain PyTorch loops: their tensors are
    small, and parallel test workers with a thread pool each would
    oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODEL_SETS = {
    "mix": ("hmm5", "partition", "local"),
    "qp": ("hmm5", "partition"),
    "hmm5": ("hmm5",),
    "local": ("local",),
    "partition": ("partition",),
}
LEAVE = 0.170705


def _batch(lp=128, b=8, lo=40, hi=100, seed=0):
    """Seeded (X, Y, LX, LY) numpy batch with unequal pair lengths."""
    rng = np.random.default_rng(seed)
    lx = rng.integers(lo, hi, size=b).astype(np.int32)
    ly = rng.integers(lo, hi, size=b).astype(np.int32)
    X = np.full((b, lp), 20, np.int8)
    Y = np.full((b, lp), 20, np.int8)
    for k in range(b):
        X[k, : lx[k]] = rng.integers(0, 20, lx[k])
        Y[k, : ly[k]] = rng.integers(0, 20, ly[k])
    return X, Y, lx, ly


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_sweeps(X, Y, lx, ly, mode, models):
    tabs_f, tabs_r = jpw._wf_tables(mode, LEAVE)
    b, lp = X.shape
    z = jnp.zeros((b,), jnp.int32)
    fwd = jwf.wavefront_forward(
        jnp.asarray(X), jnp.asarray(Y), z, z, jnp.asarray(lx),
        jnp.asarray(ly), tabs_f, models=models,
    )
    rev = jwf.wavefront_forward(
        jnp.asarray(X[:, ::-1]), jnp.asarray(Y[:, ::-1]),
        jnp.asarray(lp - lx), jnp.asarray(lp - ly), jnp.asarray(lx),
        jnp.asarray(ly), tabs_r, models=models, emit_pre=True,
    )
    return fwd, rev


def _torch_sweeps(X, Y, lx, ly, mode, models):
    tabs_f, tabs_r = tpw._wf_tables(mode, LEAVE, "cpu")
    b, lp = X.shape
    z = torch.zeros((b,), dtype=torch.int32)
    fwd = twf.wavefront_forward(_t(X), _t(Y), z, z, _t(lx), _t(ly), tabs_f,
                                models=models)
    rev = twf.wavefront_forward(
        _t(X[:, ::-1]), _t(Y[:, ::-1]), _t(lp - lx), _t(lp - ly), _t(lx),
        _t(ly), tabs_r, models=models, emit_pre=True,
    )
    return fwd, rev


def _aligned_plane_err(jres, tres, m):
    """Largest difference within a row over the row's max, after putting
    the port's stored values on the JAX side's scale."""
    sj = np.asarray(jres["scales"][m])
    st = tres["scales"][m].numpy()
    a = tres["planes"][m].numpy() * np.exp2(sj - st)[:, :, None]
    p = np.asarray(jres["planes"][m])
    rowmax = np.maximum(np.abs(p).max(axis=2), np.finfo(np.float32).tiny)
    return float((np.abs(a - p).max(axis=2) / rowmax).max())


@pytest.mark.parametrize("mode", list(MODEL_SETS))
def test_plain_engine_matches_jax(mode):
    models = MODEL_SETS[mode]
    X, Y, lx, ly = _batch(seed=1)
    jf, jr = _jax_sweeps(X, Y, lx, ly, mode, models)
    tf, tr = _torch_sweeps(X, Y, lx, ly, mode, models)
    for m in models:
        for jres, tres in ((jf, tf), (jr, tr)):
            assert _aligned_plane_err(jres, tres, m) <= 1e-5
            np.testing.assert_allclose(
                tres["log2t"][m].numpy(), np.asarray(jres["log2t"][m]),
                rtol=0, atol=2e-4,
            )

    # posterior planes, RMS combine and MWT with match counts
    jacc = None
    for m in models:
        p = jwf.posterior_skew(jf, jr, m)
        jacc = p * p if jacc is None else jacc + p * p
    jpost = (jwf.posterior_skew(jf, jr, models[0]) if len(models) == 1
             else jnp.sqrt(jacc / len(models)))
    jscore, jnb = jwf.mwt_skew(jpost, jnp.asarray(lx), jnp.asarray(ly),
                               with_matches=True)
    post, score, nb = twk.combine_reference(tf, tr, _t(lx), _t(ly), models,
                                            with_matches=True)
    jpost = np.array(jpost)
    np.testing.assert_allclose(post.numpy(), jpost, rtol=0, atol=2e-4)
    # cells outside every pair's grid are exactly zero
    D, _, W = jpost.shape
    d = np.arange(D)[:, None, None]
    j = np.arange(W)[None, None, :]
    inside = ((j >= 1) & (j <= ly[None, :, None])
              & (d - j >= 1) & (d - j <= lx[None, :, None]))
    assert not np.any(post.numpy()[~inside])
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))

    # unskew and top-k on the same plane are exact re-indexings
    same = torch.from_numpy(jpost)
    np.testing.assert_array_equal(
        twf.unskew_posterior(same).numpy(),
        np.asarray(jwf.unskew_posterior(jnp.asarray(jpost))),
    )
    vj, lj = jwf.topk_skew(jnp.asarray(jpost), 16, 0.01)
    vt, lt = twf.topk_skew(same, 16, 0.01)
    vj = np.asarray(vj)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(lt.numpy()[vj > 0],
                                  np.asarray(lj)[vj > 0])


def check_against_pallas(b, models):
    """posterior_pallas in interpret mode (the TPU kernels' semantics)
    against the port's `posterior` on CPU tensors (its plain path), both
    dense with match counts and with the fused top-k."""
    mode = "mix" if len(models) == 3 else models[0]
    X, Y, lx, ly = _batch(b=b, seed=3)
    jf, jr = jpw._wf_tables(mode, LEAVE)
    post_j, score_j, nb_j = jwk.posterior_pallas(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(lx), jnp.asarray(ly),
        jf, jr, models=models, with_matches=True, interpret=True,
    )
    tf, tr = tpw._wf_tables(mode, LEAVE, "cpu")
    post, score, nb = twk.posterior(_t(X), _t(Y), _t(lx), _t(ly), tf, tr,
                                    models=models, with_matches=True)
    D, _, W = post.shape
    post_j = np.asarray(post_j)
    np.testing.assert_allclose(post.numpy(), post_j[:D, :, :W], atol=2e-4)
    assert not np.any(post_j[D:]) and not np.any(post_j[:, :, W:])
    np.testing.assert_allclose(score.numpy(), np.asarray(score_j),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(nb.numpy(), np.asarray(nb_j))
    vals, lanes, score_k = twk.posterior(
        _t(X), _t(Y), _t(lx), _t(ly), tf, tr, models=models, topk=16,
        cutoff=0.01,
    )
    vw, lw = twf.topk_skew(post, 16, 0.01)
    np.testing.assert_allclose(vals.numpy(), vw.numpy(), atol=1e-7)
    pos = vw.numpy() > 0
    np.testing.assert_array_equal(lanes.numpy()[pos], lw.numpy()[pos])
    np.testing.assert_array_equal(score_k.numpy(), score.numpy())


def test_plain_engine_matches_pallas_interpret_small_batch():
    """B = 2, below the Pallas kernels' pair block (the long-pair
    regime).  The mix case is tests/test_torch_pallas.py."""
    check_against_pallas(2, ("hmm5",))


def test_viterbi_twin_matches_jax():
    X, Y, lx, ly = _batch(b=6, seed=5)
    pl = jpw.local_dict()
    dirs_j, ends_j, score_j = jwf.viterbi_wavefront(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(lx), jnp.asarray(ly),
        pl, jnp.asarray(jvit.VIT_INIT),
    )
    bl = jmp.blosum62()
    plen_j, match_j, srev_j = jwf.viterbi_path_stats(
        dirs_j, ends_j, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(lx),
        jnp.asarray(ly), jnp.asarray(bl),
    )
    tl = {k: torch.from_numpy(np.asarray(pl[k])) for k in
          ("lmatch", "lins", "trans")}
    dirs, ends, score = twf.viterbi_wavefront(
        _t(X), _t(Y), _t(lx), _t(ly), tl, torch.from_numpy(tpw.VIT_INIT)
    )
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_j))
    np.testing.assert_array_equal(ends.numpy(), np.asarray(ends_j))
    np.testing.assert_array_equal(score.numpy(), np.asarray(score_j))
    plen, match, srev = twf.viterbi_path_stats(
        dirs, ends, _t(X), _t(Y), _t(lx), _t(ly), torch.from_numpy(bl)
    )
    np.testing.assert_array_equal(plen.numpy(), np.asarray(plen_j))
    np.testing.assert_array_equal(match.numpy(), np.asarray(match_j))
    np.testing.assert_array_equal(srev.numpy(), np.asarray(srev_j))
