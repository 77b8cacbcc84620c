# Frozen copy of mlprobs_tpu_torch/align/refine_np.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Non-progressive refinement: k-means similar-set realignment.

Reference: MSA::DoRefinement (MSA.cpp:1852-1978) and FindSimilar
(:1986-2082).  For each sequence x, a 1-D k-means over the similarity
row splits the family into a similar set S_x and its complement N_x;
refinement realigns x against S_x - x, then S'_x against N_x, cycling
sequences in a random order until the adaptive budget is spent.

The reference seeds with srand(time(0)) here -- nondeterministic by
construction; the JAX package and the port use a fixed glibc-rand stream
for reproducibility.  Host code, as in the JAX package.
"""
from __future__ import annotations

import numpy as np

from msabench.msaref.align.progressive import PostPool, align_profiles
from msabench.msaref.core.msa import MSA
from msabench.msaref.utils.crand import GlibcRand


def find_similar(distances: np.ndarray) -> list[set[int]]:
    """Per-sequence similar sets via the reference's 1-D k-means."""
    d = distances.copy().astype(np.float64)
    n = d.shape[0]
    np.fill_diagonal(d, 1.0)
    out: list[set[int]] = []
    for i in range(n):
        row = d[i]
        # reference scans with <=/>= so later indices win ties
        ii_min, ii_max = 0, 0
        min_d, max_d = 1.0, 0.0
        for j in range(n):
            if row[j] <= min_d:
                ii_min, min_d = j, row[j]
            if row[j] >= max_d:
                ii_max, max_d = j, row[j]
        c1 = {ii_max}
        c2 = {ii_min}
        for j in range(n):
            if j not in (ii_min, ii_max):
                if abs(row[j] - max_d) < abs(row[j] - min_d):
                    c1.add(j)
                else:
                    c2.add(j)
        if i not in c1:
            c2.discard(i)
            c1.add(i)
        for _ in range(100):
            m1 = sum(row[k] for k in c1) / len(c1)
            m2 = sum(row[k] for k in c2) / len(c2)
            moved = False
            to_c2, to_c1 = [], []
            for j in range(n):
                if j == i:
                    continue
                if j in c1:
                    if abs(row[j] - m1) > abs(row[j] - m2):
                        to_c2.append(j)
                        moved = True
                elif abs(row[j] - m2) > abs(row[j] - m1):
                    to_c1.append(j)
                    moved = True
            if not moved:
                break
            for j in to_c2:
                c1.discard(j)
                c2.add(j)
            for j in to_c1:
                c2.discard(j)
                c1.add(j)
        out.append(c1)
    return out


def np_refinement(
    alignment: MSA,
    posts: dict,
    distances: np.ndarray,
    rng: GlibcRand,
    base_reps: int = 100,
) -> MSA:
    n = alignment.num_seqs
    reps = 0 if n > 150 else base_reps
    if reps == 0 or n < 2:
        return alignment
    sim = find_similar(distances)
    pool = PostPool(posts)
    cnt = 0
    oalign = 0.0
    ineff = 0
    while cnt < reps:
        pool_idx = list(range(n))
        order = []
        while pool_idx:
            order.append(pool_idx.pop(rng.rand() % len(pool_idx)))
        for si in order:
            g1 = sorted(sim[si])
            g1set = set(g1)
            g2 = [j for j in range(n) if j not in g1set]
            cnt += 1
            if not g1 or not g2:
                continue
            grp1 = alignment.project(g1)
            grp2 = alignment.project(g2)
            idx_in_g1 = g1.index(si)
            if grp1.num_seqs > 1:
                solo = grp1.project([idx_in_g1])
                rest = grp1.project(
                    [k for k in range(grp1.num_seqs) if k != idx_in_g1]
                )
                grp1, score2 = align_profiles(solo, rest, posts, None,
                                              pool=pool)
                if not score2 > 0.0:
                    ineff += 1
                cnt += 1
            alignment, score = align_profiles(grp1, grp2, posts, None,
                                              pool=pool)
            if score < oalign and reps < 8 * n and ineff < 4 * n:
                oalign = score
                reps += n
    return alignment
