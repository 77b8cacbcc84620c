"""The host side of the consistency route at many small pairs: the
relaxation's CSRs extracted with their entries kept on the device
(`pairwise._kept_entries`, `_entries_to_csrs`), the relaxed planes cut
to the longest sequence, and `progressive.PostPool` built for all pairs
at once, each against the pair-by-pair construction it replaces
(`topk_to_csr` a pair; a COO, a stable sort by column a pair), equal
bit for bit."""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from mlprobs_tpu_torch.align import consistency as tcons  # noqa: E402
from mlprobs_tpu_torch.align import pairwise as tpw  # noqa: E402
from mlprobs_tpu_torch.align.progressive import PostPool  # noqa: E402

# (N, shortest, longest, Lp): block fragments padded to the length
# bucket, a base call's lengths, and rows longer than the top-k
SHAPES = [(30, 3, 10, 128), (8, 20, 60, 64), (6, 70, 90, 128)]


def _planes(n, lo, hi, lp, seed):
    """(N, N, Lp, Lp) posteriors zero past each pair's lengths, with
    ties, and the lengths."""
    g = torch.Generator().manual_seed(seed)
    lens = [int(x) for x in torch.randint(lo, hi + 1, (n,), generator=g)]
    S = torch.zeros(n, n, lp, lp)
    for i in range(n):
        for j in range(i + 1, n):
            x = torch.rand(lens[i], lens[j], generator=g)
            x = torch.where(x < 0.6, 0.0, x)
            x = torch.where(x > 0.95, 0.97, x)          # ties
            S[i, j, :lens[i], :lens[j]] = x
            S[j, i, :lens[j], :lens[i]] = x.T
    return S, lens


def _pair_by_pair(planes, pairs, lens, k):
    vals, idx = tpw._row_topk(planes, k)
    vals, idx = vals.numpy(), idx.numpy()
    return {(i, j): tpw.topk_to_csr(vals[q], idx[q], lens[i], lens[j])
            for q, (i, j) in enumerate(pairs)}


def _same(got, want):
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        for a in ("indptr", "indices", "data"):
            x, y = getattr(g, a), getattr(w, a)
            assert x.dtype == y.dtype and np.array_equal(x, y), (key, a)


@pytest.mark.parametrize("k", [tpw.EXTRACT_TOPK, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_extracted_csrs_equal_pair_by_pair(shape, k, monkeypatch):
    monkeypatch.setattr(tpw, "EXTRACT_TOPK", k)
    S, lens = _planes(*shape, seed=1)
    n = len(lens)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    t = tpw.DevicePosteriorTensor(S, pairs, None, lens)
    ii, jj = t._pair_index(S.device)
    _same(t.extract_csrs(), _pair_by_pair(S[ii, jj], pairs, lens, k))


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_relaxed_planes_cut_to_the_longest_sequence(shape):
    """relax_and_extract's planes are as wide as the longest sequence;
    its CSRs equal those of the planes at the tensor's full width."""
    S, lens = _planes(*shape, seed=2)
    n = len(lens)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    w = np.linspace(0.5, 1.5, n)
    got = tpw.DevicePosteriorTensor(S, pairs, None, lens).relax_and_extract(
        weights=w, reps=1, final_cutoff=1e-5)
    sc, zs, ww = tcons.dense_relax_coeffs(n, w, selfweight=3.0,
                                          selectivity=200.0)
    full = tcons.Packing(lens, pairs, S.shape[-1], S.device)
    R = tcons.relax_packed_rounds(full.pack(S), full, sc, zs, ww, reps=1,
                                  final_cutoff=1e-5)
    _same(got, _pair_by_pair(full.unpack(R), pairs, lens,
                             tpw.EXTRACT_TOPK))


def _pool_pair_by_pair(posts):
    """{(a, b): (rows, cols, values)} as PostPool stored them a pair at a
    time: storage order, then the transpose by a stable sort of the
    columns."""
    want = {}
    for (i, j), s in posts.items():
        coo = s.tocsr().tocoo()
        r = coo.row.astype(np.int32)
        c = coo.col.astype(np.int32)
        v = coo.data.astype(np.float32)
        t = np.argsort(c, kind="stable")
        want[(i, j)] = (r, c, v)
        want[(j, i)] = (c[t], r[t], v[t])
    return want


def _posts(n, lo, hi, density, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    return {(i, j): sp.random(lens[i], lens[j], density=density,
                              format="csr", dtype=np.float32,
                              random_state=rng)
            for i in range(n) for j in range(i + 1, n)}


@pytest.mark.parametrize("n,lo,hi,density", [
    (40, 1, 8, 0.3),        # block fragments, some pairs empty
    (10, 50, 90, 0.05),     # a base call's pairs
    (3, 1, 1, 0.0),         # nothing to pool
])
def test_pool_equals_pair_by_pair(n, lo, hi, density):
    posts = _posts(n, lo, hi, density, seed=n)
    pool = PostPool(posts)
    want = _pool_pair_by_pair(posts)
    assert {tuple(k) for k in np.argwhere(pool.start >= 0)} == set(want)
    for key, (r, c, v) in want.items():
        start, m = pool.start[key], pool.len[key]
        assert m == len(v)
        assert np.array_equal(pool.r[start:start + m], r)
        assert np.array_equal(pool.c[start:start + m], c)
        assert np.array_equal(pool.v[start:start + m], v)
    assert (pool.r.dtype, pool.c.dtype, pool.v.dtype) == \
        (np.int32, np.int32, np.float32)


def test_pool_lookup_skips_pairs_it_does_not_hold():
    """The pairs of two label groups, row-major, as the scatter's loop
    over them found them in a dict of the pairs: a pair missing from the
    posts dict and a label past every pair are left out."""
    posts = _posts(5, 2, 4, 0.5, seed=9)
    del posts[(1, 3)]
    pool = PostPool(posts)
    held_pairs = set(posts) | {(j, i) for i, j in posts}
    la, lb = np.array([3, 0, 7]), np.array([1, 4, 2])
    held, starts, lens = pool.lookup(la, lb)
    want = [(a, b) for a in range(3) for b in range(3)
            if (int(la[a]), int(lb[b])) in held_pairs]
    assert [tuple(x) for x in np.argwhere(held)] == want
    assert starts.tolist() == [pool.start[la[a], lb[b]] for a, b in want]
    assert lens.tolist() == [
        posts[tuple(sorted((int(la[a]), int(lb[b]))))].nnz
        for a, b in want]
