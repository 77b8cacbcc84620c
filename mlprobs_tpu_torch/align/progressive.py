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


def mwt_path(post: np.ndarray) -> tuple[np.ndarray, float]:
    """Run the MWT DP on a dense posterior plane; return (path, score)."""
    lx, ly = post.shape
    dirs, score = host.mwt_fill(np.asarray(post))
    return tbk.mwt_traceback(dirs, lx, ly), score


class PostPool:
    """Pooled COO of all ordered pair posteriors.

    Built once per posts dict so that the host profile builder can
    scatter every inter-group pair without per-pair Python/scipy work;
    `index[(la, lb)]` -> (start, len) into the shared (r, c, v) pools
    (both orientations stored, each sorted by row, as the host scatter
    requires)."""

    def __init__(self, posts: dict[tuple[int, int], sp.csr_matrix]):
        rs, cs, vs = [], [], []
        self.index: dict[tuple[int, int], tuple[int, int]] = {}
        off = 0
        for (i, j), s in posts.items():
            coo = s.tocsr().tocoo()          # row-major: sorted by row
            r = coo.row.astype(np.int32)
            c = coo.col.astype(np.int32)
            v = coo.data.astype(np.float32)
            t = np.argsort(c, kind="stable")
            rs += [r, c[t]]
            cs += [c, r[t]]
            vs += [v, v[t]]
            self.index[(i, j)] = (off, len(v))
            off += len(v)
            self.index[(j, i)] = (off, len(v))
            off += len(v)
        z32 = np.zeros(0, np.int32)
        self.r = np.concatenate(rs) if rs else z32
        self.c = np.concatenate(cs) if cs else z32
        self.v = (np.concatenate(vs) if vs
                  else np.zeros(0, np.float32))


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
    l1, l2 = group1.length, group2.length
    maps1 = [np.flatnonzero(group1.rows[a] >= 0).astype(np.int32)
             for a in range(group1.num_seqs)]
    maps2 = [np.flatnonzero(group2.rows[b] >= 0).astype(np.int32)
             for b in range(group2.num_seqs)]
    m1_off = np.zeros(len(maps1) + 1, np.int64)
    m1_off[1:] = np.cumsum([len(m) for m in maps1])
    m2_off = np.zeros(len(maps2) + 1, np.int64)
    m2_off[1:] = np.cumsum([len(m) for m in maps2])
    n1, n2 = group1.num_seqs, group2.num_seqs
    la = [int(x) for x in group1.labels]
    lb = [int(x) for x in group2.labels]
    if weights is not None:
        total_w = sum(
            float(weights[a]) * float(weights[b])
            for a in la for b in lb
        ) or 1.0
    starts = np.empty(n1 * n2, np.int64)
    lens = np.empty(n1 * n2, np.int64)
    a_idx = np.empty(n1 * n2, np.int32)
    b_idx = np.empty(n1 * n2, np.int32)
    wts = np.empty(n1 * n2, np.float64)
    k = 0
    for a in range(n1):
        for b in range(n2):
            ent = pool.index.get((la[a], lb[b]))
            if ent is None:
                continue
            starts[k], lens[k] = ent
            a_idx[k], b_idx[k] = a, b
            wts[k] = (
                float(weights[la[a]]) * float(weights[lb[b]]) / total_w
                if weights is not None else 1.0
            )
            k += 1
    return host.profile_posterior(
        l1, l2, starts[:k], lens[:k], a_idx[:k], b_idx[:k], wts[:k],
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
    alignment = process_tree(root, seqs_msa, posts, weights, pool=pool)

    reps = base_reps
    if pid > 3 or n > 150:
        reps = 0
    if n <= 50:
        reps = 2 * reps
    ineffectiveness = 0
    i = 0
    iter_cutoff = 100
    while i < reps:
        alignment, flag = iterative_refinement_pass(
            alignment, posts, rng, pool=pool
        )
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
