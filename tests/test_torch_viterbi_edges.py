"""The feature pass's plain Viterbi (`viterbi_kernel.viterbi_reference`,
the port's copies of `viterbi_wavefront` and `viterbi_path_stats`)
against the JAX package's two functions, on the inputs where the CUDA
kernel's design has its edges: empty and one-residue sequences, one
residue repeated (ties among equal scores decide the direction bits),
padding far longer than both sequences, and lengths where the walk runs
past the pair's rectangle and its indices wrap.  Same numpy inputs on
both sides, CPU; every output equal exactly, as tests/test_torch_align.py
holds the family statistics.  Also the wrapper's cache of the packed
table block.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from mlprobs_tpu.ops import wavefront as jwf  # noqa: E402
from mlprobs_tpu_torch.align import pairwise as tpw  # noqa: E402
from mlprobs_tpu_torch.ops.kernels import viterbi_kernel as tvk  # noqa: E402

OUT = ("dirs", "end_state", "score", "pathlen", "matches", "scores_rev")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(kind, lp, b, seed):
    """(X, Y, lx, ly) numpy: b pairs padded to lp, of the given kind."""
    rng = np.random.default_rng(seed)
    if kind == "empty":        # one side or both of length 0
        lx = rng.integers(0, lp + 1, size=b)
        ly = rng.integers(0, lp + 1, size=b)
        lx[::2] = 0
        ly[1::2] = 0
        ly[-1] = lx[-1] = 0
    elif kind == "ones":       # lengths of 0, 1 and 2
        lx = rng.integers(0, 3, size=b)
        ly = rng.integers(0, 3, size=b)
        lx[0], ly[0] = 1, 1
    elif kind == "short":      # Lp far above both lengths
        lx = rng.integers(1, max(2, lp // 8), size=b)
        ly = rng.integers(1, max(2, lp // 8), size=b)
    else:                      # "repeat", "random": lengths in [lp/2, lp]
        lx = rng.integers(max(1, lp // 2), lp + 1, size=b)
        ly = rng.integers(max(1, lp // 2), lp + 1, size=b)
        lx[0] = ly[-1] = lp
    lx, ly = np.minimum(lx, lp), np.minimum(ly, lp)
    X = np.full((b, lp), 20, np.int8)
    Y = np.full((b, lp), 20, np.int8)
    for k in range(b):
        if kind == "repeat":
            X[k, : lx[k]] = Y[k, : ly[k]] = rng.integers(0, 20)
        else:
            X[k, : lx[k]] = rng.integers(0, 20, lx[k])
            Y[k, : ly[k]] = rng.integers(0, 20, ly[k])
    return X, Y, lx.astype(np.int32), ly.astype(np.int32)


CASES = [("empty", 16, 6), ("ones", 8, 8), ("ones", 1, 4), ("repeat", 24, 5),
         ("repeat", 5, 3), ("short", 64, 4), ("random", 33, 3),
         ("random", 64, 2)]


@pytest.mark.parametrize("kind,lp,b", CASES,
                         ids=[f"{k}-{lp}x{b}" for k, lp, b in CASES])
def test_viterbi_reference_matches_jax(kind, lp, b):
    X, Y, lx, ly = _pairs(kind, lp, b, seed=lp * 31 + b)
    pl, vinit, bl = tpw.viterbi_tables(tpw.mp.blosum62(), "cpu")
    got = tvk.viterbi_reference(*(torch.from_numpy(a) for a in (X, Y, lx,
                                                                  ly)),
                                pl, vinit, bl)
    jp = {k: jnp.asarray(v.numpy()) for k, v in pl.items()}
    jx, jy, jlx, jly = (jnp.asarray(a) for a in (X, Y, lx, ly))
    dirs, ends, score = jwf.viterbi_wavefront(jx, jy, jlx, jly, jp,
                                              jnp.asarray(vinit.numpy()))
    plen, matches, srev = jwf.viterbi_path_stats(
        dirs, ends, jx, jy, jlx, jly, jnp.asarray(bl.numpy()))
    want = (dirs, ends, score, plen, matches, srev)
    for name, a, w in zip(OUT, got, want):
        w = np.asarray(w)
        assert a.shape == w.shape, name
        np.testing.assert_array_equal(a.numpy(), w, err_msg=name)


def test_packed_tables_cache():
    """The wrapper packs the table block once for the same unmodified
    tensors, and anew after an in-place change or for other tensors."""
    dev = torch.device("cpu")
    pl, vinit, bl = tpw.viterbi_tables(tpw.mp.blosum62(), dev)
    first = tvk._packed_tables(pl, vinit, bl, dev)
    assert tvk._packed_tables(pl, vinit, bl, dev) is first
    pl["lins"][3] += 1.0
    changed = tvk._packed_tables(pl, vinit, bl, dev)
    assert changed is not first
    assert torch.equal(changed, tvk.pack_tables(pl, vinit, bl, dev))
    pl2, vinit2, bl2 = tpw.viterbi_tables(tpw.mp.blosum62(), dev)
    again = tvk._packed_tables(pl2, vinit2, bl2, dev)
    assert again is not changed
    assert torch.equal(again, tvk.pack_tables(pl2, vinit2, bl2, dev))
