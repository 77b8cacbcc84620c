"""The port's host profile-posterior scatter (csrc/host.cpp
`profile_posterior`) against the JAX package's numpy path
(`build_profile_posterior` without a pool): equal bit for bit at 1, 2 and
8 OpenMP threads, with and without weights and the cutoff subtraction;
and one seeded family's merge giving the same MSA at 1 and 8 threads.

The thread count is fixed per process (OMP_NUM_THREADS), so the port
runs in a subprocess for each count; inputs and outputs cross as pickles
written by this test.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from mlprobs_tpu.align import progressive as jprog  # noqa: E402
from mlprobs_tpu.core.msa import MSA as JMSA  # noqa: E402
from mlprobs_tpu_torch.align import aligner as tal  # noqa: E402
from mlprobs_tpu_torch.align import tree as ttree  # noqa: E402
from mlprobs_tpu_torch.core.alphabet import encode  # noqa: E402
from mlprobs_tpu_torch.core.msa import MSA  # noqa: E402
from mlprobs_tpu_torch.utils.synth import synthetic_family  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
THREADS = (1, 2, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain PyTorch loops: their tensors are
    small, and parallel test workers with a thread pool each would
    oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gapped_group(rng, labels, length, lens):
    """An MSA of `length` columns whose rows hold lens[k] residues at
    random columns, labelled `labels`."""
    rows = np.full((len(labels), length), -1, np.int8)
    for k, n in enumerate(lens):
        cols = np.sort(rng.choice(length, n, replace=False))
        rows[k, cols] = rng.integers(0, 20, n)
    return rows


def _scatter_inputs(seed=0):
    """Two gapped groups over 22 labels and random sparse posteriors of
    every pair, many pairs landing in each profile cell."""
    rng = np.random.default_rng(seed)
    n1, n2, l1, l2 = 12, 10, 170, 150
    lens = rng.integers(90, 140, n1 + n2)
    lab1 = rng.permutation(n1 + n2)[:n1]
    lab2 = np.setdiff1d(np.arange(n1 + n2), lab1)
    r1 = _gapped_group(rng, lab1, l1, [lens[a] for a in lab1])
    r2 = _gapped_group(rng, lab2, l2, [lens[b] for b in lab2])
    posts = {}
    for i in range(n1 + n2):
        for j in range(i + 1, n1 + n2):
            m = sp.random(lens[i], lens[j], density=0.05, format="csr",
                          random_state=int(rng.integers(1 << 31)),
                          dtype=np.float32)
            m.data = (0.01 + 0.99 * m.data).astype(np.float32)
            posts[(i, j)] = m
    weights = rng.random(n1 + n2) + 0.1
    heads1 = [f"s{a}" for a in lab1]
    heads2 = [f"s{b}" for b in lab2]
    return (heads1, r1, lab1.astype(np.int32)), \
        (heads2, r2, lab2.astype(np.int32)), posts, weights


_PORT_SCATTER = """
import pickle, sys
from mlprobs_tpu_torch.align import progressive
from mlprobs_tpu_torch.core.msa import MSA
g1, g2, posts, weights, cases = pickle.load(open(sys.argv[1], "rb"))
g1, g2 = MSA(*g1), MSA(*g2)
pool = progressive.PostPool(posts)
out = [progressive.build_profile_posterior(
           g1, g2, posts, weights if weighted else None,
           cutoff_sub=cut, pool=pool) for weighted, cut in cases]
out += [progressive.build_profile_posterior(g1, g2, posts, weights,
                                            cutoff_sub=0.01, pool=pool)
        for _ in range(3)]
pickle.dump(out, open(sys.argv[2], "wb"))
"""

_PORT_MERGE = """
import pickle, sys
from mlprobs_tpu_torch.align import progressive, tree
from mlprobs_tpu_torch.core.msa import MSA
from mlprobs_tpu_torch.utils.crand import GlibcRand
records, posts, dist = pickle.load(open(sys.argv[1], "rb"))
root = tree.upgma(dist, variance_id=0)
msa = progressive.compute_final_alignment(
    root, MSA.from_unaligned(records), posts, pid=0, rng=GlibcRand(1),
    base_reps=20)
pickle.dump(msa.content_hash(), open(sys.argv[2], "wb"))
"""


def _run_port(code, payload, threads, tmp_path):
    src, dst = tmp_path / f"in{threads}.pkl", tmp_path / f"out{threads}.pkl"
    src.write_bytes(pickle.dumps(payload))
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    subprocess.run([sys.executable, "-c", code, str(src), str(dst)],
                   cwd=ROOT, env=env, check=True, timeout=300)
    return pickle.loads(dst.read_bytes())


CASES = ((False, 0.0), (True, 0.0), (False, 0.01), (True, 0.01))


@pytest.mark.parametrize("threads", THREADS)
def test_scatter_bit_equal_to_numpy_order(threads, tmp_path):
    g1, g2, posts, weights = _scatter_inputs()
    j1, j2 = JMSA(*g1), JMSA(*g2)
    want = [jprog.build_profile_posterior(
        j1, j2, posts, weights if weighted else None, cutoff_sub=cut,
        pool=None) for weighted, cut in CASES]
    got = _run_port(_PORT_SCATTER, (g1, g2, posts, weights, CASES),
                    threads, tmp_path)
    for (weighted, cut), g, w in zip(CASES, got, want):
        assert g.dtype == w.dtype == np.float32
        assert np.array_equal(g, w), (threads, weighted, cut,
                                      int((g != w).sum()))
    # repeated calls in one process: the same plane every time
    for g in got[len(CASES):]:
        assert np.array_equal(g, want[3])


def test_pool_entries_sorted_by_row():
    """The host scatter finds a band's entries by binary search over each
    pair's rows, so PostPool must store both orientations sorted."""
    from mlprobs_tpu_torch.align.progressive import PostPool

    _, _, posts, _ = _scatter_inputs(seed=1)
    pool = PostPool(posts)
    for (a, b), (start, n) in pool.index.items():
        r = pool.r[start:start + n]
        assert np.all(np.diff(r) >= 0), (a, b)
        lo, hi = min(a, b), max(a, b)
        m = posts[(lo, hi)] if a < b else posts[(lo, hi)].T.tocsr()
        got = sp.csr_matrix((pool.v[start:start + n],
                             (r, pool.c[start:start + n])), shape=m.shape)
        assert (got != m).nnz == 0


def test_family_merge_same_msa_at_1_and_8_threads(tmp_path):
    records = synthetic_family(10, 40, 60, sub=0.4, indel=0.1, seed=3)
    seqs = [encode(s) for _, s in records]
    posts, dist = tal.posterior_stage(seqs, "mix", 0.170705, device="cpu")
    hashes = {t: _run_port(_PORT_MERGE, (records, posts, dist), t, tmp_path)
              for t in (1, 8)}
    assert hashes[1] == hashes[8]
    # the same merge in this process gives it too
    from mlprobs_tpu_torch.align import progressive
    from mlprobs_tpu_torch.utils.crand import GlibcRand

    msa = progressive.compute_final_alignment(
        ttree.upgma(dist, variance_id=0), MSA.from_unaligned(records),
        posts, pid=0, rng=GlibcRand(1), base_reps=20)
    assert msa.content_hash() == hashes[1]
