"""Progressive profile-profile alignment and iterative refinement.

Reference: MSA::ProcessTree/AlignAlignments (MSA.cpp:1369-1471),
ProbabilisticModel::BuildPosterior weighted/unweighted
(ProbabilisticModel.h:1197-1379), ComputeFinalAlignment +
DoIterativeRefinement (MSA.cpp:1481-1623).

The profile posterior is a weighted scatter of every inter-group sparse
pair posterior through the gap mappings; the merge itself is the MWT DP
and its traceback.  All of it runs on the host (utils/host.py).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from mlprobs_tpu_torch.align import traceback as tbk
from mlprobs_tpu_torch.align.tree import TreeNode, clustalw_weights
from mlprobs_tpu_torch.core.msa import MSA, merge_alignments
from mlprobs_tpu_torch.utils import host
from mlprobs_tpu_torch.utils.crand import GlibcRand
from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS


def mwt_path(post: np.ndarray) -> tuple[np.ndarray, float]:
    """Run the MWT DP on a dense posterior plane; return (path, score)."""
    lx, ly = post.shape
    with STATS.step("fill"):
        dirs, score = host.mwt_fill(np.asarray(post))
    STATS.count("fill_cells", lx * ly)
    with STATS.step("traceback"):
        path = tbk.mwt_traceback(dirs, lx, ly)
    return path, score


class PostPool:
    """Pooled COO of all ordered pair posteriors.

    Built once per posts dict so that the host profile builder can
    scatter every inter-group pair without per-pair Python/scipy work:
    `start[la, lb]`, `len[la, lb]` (M x M over the labels; start -1: no
    pair) place each ordered pair in the shared (r, c, v) pools (both
    orientations stored, each sorted by row, as the host scatter
    requires).  The pairs are the blocks of one block-diagonal CSR: the
    pools hold its entries in storage order, then those of its `tocsc`
    (each pair's transpose, by column, ties in storage order)."""

    @STATS.sub("pool")
    def __init__(self, posts: dict[tuple[int, int], sp.csr_matrix]):
        mats = [s.tocsr() for s in posts.values()]
        shapes = np.array([m.shape for m in mats], np.int64).reshape(-1, 2)
        ptrs = (np.concatenate([m.indptr for m in mats]).astype(np.int64)
                if mats else np.zeros(0, np.int64))
        last = np.cumsum(shapes[:, 0] + 1) - 1     # each pair's indptr end
        nnz = ptrs[last]
        start = np.zeros(len(mats) + 1, np.int64)
        np.cumsum(nnz, out=start[1:])
        total = int(start[-1])
        ij = np.array(list(posts), np.int64).reshape(-1, 2)
        labels = int(ij.max()) + 1 if len(ij) else 0
        self.start = np.full((labels, labels), -1, np.int64)
        self.len = np.zeros((labels, labels), np.int64)
        self.start[ij[:, 0], ij[:, 1]] = start[:-1]
        self.start[ij[:, 1], ij[:, 0]] = total + start[:-1]
        self.len[ij[:, 0], ij[:, 1]] = nnz
        self.len[ij[:, 1], ij[:, 0]] = nnz
        if not total:
            self.r = self.c = np.zeros(0, np.int32)
            self.v = np.zeros(0, np.float32)
            return
        # each pair is a block of one block-diagonal CSR: its rows and
        # columns, and their positions within the pair
        nr, nc = (int(x) for x in shapes.sum(0))
        c0 = np.zeros(len(mats), np.int32)
        np.cumsum(shapes[:-1, 1], out=c0[1:])
        row_pos = _positions(shapes[:, 0], nr)
        col_pos = _positions(shapes[:, 1], nc)
        per_row = np.delete(np.diff(ptrs), last[:-1])
        ptr = np.zeros(nr + 1, np.int64)
        np.cumsum(per_row, out=ptr[1:])
        c = np.concatenate([m.indices for m in mats]).astype(np.int32)
        v = np.concatenate([m.data for m in mats]).astype(np.float32)
        c += c0.repeat(nnz)
        t = sp.csr_matrix((v, c, ptr), shape=(nr, nc)).tocsc()
        self.r = np.concatenate([row_pos.repeat(per_row),
                                 col_pos.repeat(np.diff(t.indptr))])
        self.c = np.concatenate([col_pos[c], row_pos[t.indices]])
        self.v = np.concatenate([v, t.data])

    def lookup(self, la: np.ndarray, lb: np.ndarray):
        """The pairs of labels la x lb that the pool holds: a (len(la),
        len(lb)) mask, and their starts and lengths in row-major
        order."""
        m = len(self.start)
        held = (la < m)[:, None] & (lb < m)[None, :]
        ia, ib = np.where(la < m, la, 0), np.where(lb < m, lb, 0)
        if m:
            held &= self.start[ia][:, ib] >= 0
        a, b = np.nonzero(held)
        return held, self.start[ia[a], ib[b]], self.len[ia[a], ib[b]]


def _positions(sizes: np.ndarray, total: int) -> np.ndarray:
    """0, 1, .., sizes[0] - 1, 0, 1, .., sizes[1] - 1, ... (int32)."""
    at = np.arange(total, dtype=np.int32)
    first = np.zeros(len(sizes), np.int32)
    np.cumsum(sizes[:-1], out=first[1:])
    return at - first.repeat(sizes)


def build_profile_posterior(
    group1: MSA,
    group2: MSA,
    posts: dict[tuple[int, int], sp.csr_matrix],
    weights: np.ndarray | None = None,
    cutoff_sub: float = 0.0,
    pool: PostPool | None = None,
) -> np.ndarray:
    """Dense (L1, L2) profile posterior by scatter through gap mappings.

    `weights` are ClustalW weights indexed by original label; if None the
    unweighted builder is used (refinement path).  `cutoff_sub` is the
    QuickProbs posteriorCutoff subtraction (ProbabilisticModel.h:
    1253-1257); the base aligner runs with cutoff 0 (MSA.cpp:38).
    """
    if pool is None:
        pool = PostPool(posts)
    with STATS.step("scatter"):
        return _scatter(group1, group2, weights, cutoff_sub, pool)


def _scatter(group1: MSA, group2: MSA, weights, cutoff_sub: float,
             pool: PostPool) -> np.ndarray:
    """`build_profile_posterior`'s pair list and host scatter."""
    l1, l2 = group1.length, group2.length
    maps1 = [np.flatnonzero(group1.rows[a] >= 0).astype(np.int32)
             for a in range(group1.num_seqs)]
    maps2 = [np.flatnonzero(group2.rows[b] >= 0).astype(np.int32)
             for b in range(group2.num_seqs)]
    m1_off = np.zeros(len(maps1) + 1, np.int64)
    m1_off[1:] = np.cumsum([len(m) for m in maps1])
    m2_off = np.zeros(len(maps2) + 1, np.int64)
    m2_off[1:] = np.cumsum([len(m) for m in maps2])
    la = np.asarray(group1.labels, np.int64)
    lb = np.asarray(group2.labels, np.int64)
    held, starts, lens = pool.lookup(la, lb)
    a_idx, b_idx = (x.astype(np.int32) for x in np.nonzero(held))
    if weights is not None:
        w = np.asarray(weights, np.float64)
        prod = np.multiply.outer(w[la], w[lb])
        # Python's float sum, over the pairs in row-major order
        total_w = sum(prod.ravel().tolist()) or 1.0
        wts = prod[held] / total_w
    else:
        wts = np.ones(len(starts), np.float64)
    STATS.count("scatter_entries", int(lens.sum()))
    return host.profile_posterior(
        l1, l2, starts, lens, a_idx, b_idx, wts,
        pool.r, pool.c, pool.v,
        np.concatenate(maps1) if maps1 else np.zeros(0, np.int32),
        m1_off,
        np.concatenate(maps2) if maps2 else np.zeros(0, np.int32),
        m2_off,
        cutoff_sub,
    )


def align_profiles(
    group1: MSA,
    group2: MSA,
    posts: dict[tuple[int, int], sp.csr_matrix],
    weights: np.ndarray | None,
    cutoff_sub: float = 0.0,
    pool: PostPool | None = None,
) -> tuple[MSA, float]:
    """AlignAlignments: profile posterior -> MWT -> merge -> sort."""
    prof = build_profile_posterior(group1, group2, posts, weights,
                                   cutoff_sub=cutoff_sub, pool=pool)
    path, score = mwt_path(prof)
    merged = merge_alignments(group1, group2, path)
    STATS.count("merges")
    return merged.sort_by_label(), score


def process_tree(
    node: TreeNode,
    seqs_msa: MSA,
    posts: dict[tuple[int, int], sp.csr_matrix],
    weights: np.ndarray,
    cutoff_sub: float = 0.0,
    pool: PostPool | None = None,
) -> MSA:
    if pool is None:
        pool = PostPool(posts)
    if node.leaf:
        return seqs_msa.project([node.idx])
    left = process_tree(node.left, seqs_msa, posts, weights,
                        cutoff_sub, pool)
    right = process_tree(node.right, seqs_msa, posts, weights,
                         cutoff_sub, pool)
    merged, _ = align_profiles(left, right, posts, weights,
                               cutoff_sub, pool)
    return merged


def iterative_refinement_pass(
    alignment: MSA,
    posts: dict[tuple[int, int], sp.csr_matrix],
    rng: GlibcRand,
    pool: PostPool | None = None,
) -> tuple[MSA, int]:
    """One DoIterativeRefinement pass.  Returns (alignment, flag).

    flag: 2 = degenerate split, 1 = score unchanged, 0 = changed.
    The realigned MSA always replaces the input (reference semantics).
    """
    n = alignment.num_seqs
    group1_idx = [i for i in range(n) if rng.rand() % 2]
    group2_idx = [i for i in range(n) if i not in set(group1_idx)]
    if not group1_idx or not group2_idx:
        return alignment, 2
    g1 = alignment.project(group1_idx)
    g2 = alignment.project(group2_idx)
    prof = build_profile_posterior(g1, g2, posts, weights=None,
                                   pool=pool)

    # accuracy of the current alignment under the profile posterior
    in1 = (alignment.rows[group1_idx] >= 0).any(axis=0)
    in2 = (alignment.rows[group2_idx] >= 0).any(axis=0)
    pos1 = np.cumsum(in1) - 1
    pos2 = np.cumsum(in2) - 1
    both = in1 & in2
    accuracy_before = (float(prof[pos1[both], pos2[both]].sum())
                       if both.any() else 0.0)

    path, score = mwt_path(prof)
    merged = merge_alignments(g1, g2, path)
    flag = 1 if accuracy_before == score else 0
    return merged, flag


def compute_final_alignment(
    root: TreeNode,
    seqs_msa: MSA,
    posts: dict[tuple[int, int], sp.csr_matrix],
    pid: int,
    rng: GlibcRand,
    base_reps: int = 100,
) -> MSA:
    """ProcessTree + the adaptive refinement loop (MSA.cpp:1481-1534)."""
    n = seqs_msa.num_seqs
    weights = clustalw_weights(root, n)
    pool = PostPool(posts)
    with STATS.sub("tree"):
        alignment = process_tree(root, seqs_msa, posts, weights, pool=pool)

    reps = base_reps
    if pid > 3 or n > 150:
        reps = 0
    if n <= 50:
        reps = 2 * reps
    ineffectiveness = 0
    i = 0
    iter_cutoff = 100
    with STATS.sub("refine"):
        while i < reps:
            alignment, flag = iterative_refinement_pass(
                alignment, posts, rng, pool=pool
            )
            STATS.count("passes")
            STATS.count("passes_changed", int(flag == 0))
            if n > 20:
                if n < 200:
                    if flag > 0:
                        if reps < 4 * n:
                            reps += 1
                        if flag == 1:
                            ineffectiveness += 1
                    if ineffectiveness > 2 * n and i > iter_cutoff:
                        break
                elif n > 200:
                    reps = 10
            i += 1
    return alignment
