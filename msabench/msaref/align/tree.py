# Frozen copy of mlprobs_tpu_torch/align/tree.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Guide trees: UPGMA cluster tree + ClustalW sequence weights.

Reproduces the reference's linked-list UPGMA (MSAClusterTree.cpp:30-190)
including scan order and tie-breaking: candidate pairs are visited in
ascending (i, j) slot order with strict `<` comparison, linkage is plain
average when `varianceid == 0` and leaf-count-weighted average otherwise
(:275-276), and each join assigns both children branch length minDist/2.

Sequence weights follow MSAGuideTree::getSeqsWeights
(MSAGuideTree.cpp:272-298): leaf weight = sum of dist/order along the
root path, quantised to int(100 * w).  The QuickProbs-role realigner
takes `qp_weights`, the same sums unquantised and normalised to 1.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TreeNode:
    idx: int                      # leaf: sequence index; internal: node id
    left: "TreeNode | None" = None
    right: "TreeNode | None" = None
    parent: "TreeNode | None" = None
    dist: float = 0.0             # branch length to parent
    leaf: bool = True


def upgma(distances: np.ndarray, variance_id: int = 1) -> TreeNode:
    """Build the cluster tree over an (N, N) distance matrix."""
    n = distances.shape[0]
    if n == 1:
        return TreeNode(idx=0)
    d = distances.astype(np.float64).copy()
    nodes = [TreeNode(idx=i) for i in range(n)]
    # slot -> current cluster node, leaf count; None = removed
    slot_node: list[TreeNode | None] = list(nodes)
    slot_count = [1] * n

    big = np.float64(1.1)
    for step in range(n - 1):
        valid = np.array(
            [s for s in range(n) if slot_node[s] is not None]
        )
        # scan pairs (si, sj<si) in ascending slot order with strict `<`:
        # row-major argmin over the masked lower triangle reproduces the
        # reference's first-minimum tie-break (MSAClusterTree.cpp:87-114)
        sub = np.maximum(d[np.ix_(valid, valid)], 0.0)
        mask = np.tril(np.ones_like(sub, dtype=bool), k=-1)
        sub = np.where(mask, sub, big)
        flat = int(np.argmin(sub))
        a, b = divmod(flat, len(valid))
        bi, bj = int(valid[a]), int(valid[b])
        best = float(sub[a, b])
        ni, nj = slot_node[bi], slot_node[bj]
        parent = TreeNode(idx=n + step, leaf=False, left=ni, right=nj)
        half = best * 0.5
        ni.parent = nj.parent = parent
        ni.dist = nj.dist = half
        ci, cj = slot_count[bi], slot_count[bj]
        # update distances to the merged cluster (stored in slot bi)
        for s in range(n):
            if slot_node[s] is None or s in (bi, bj):
                continue
            if variance_id == 0:
                nd = (d[bi, s] + d[bj, s]) / 2.0
            else:
                nd = (d[bi, s] * ci + d[bj, s] * cj) / (ci + cj)
            d[bi, s] = d[s, bi] = nd
        slot_node[bi] = parent
        slot_count[bi] = ci + cj
        slot_node[bj] = None
    root = slot_node[[s for s in range(n) if slot_node[s] is not None][0]]
    return root


def leaves(node: TreeNode) -> list[int]:
    if node.leaf:
        return [node.idx]
    return leaves(node.left) + leaves(node.right)


def qp_weights(root: TreeNode, num_seqs: int) -> np.ndarray:
    """QuickProbs sequence weights (GuideTree::calculateSeqsWeights,
    GuideTree.cpp:114-153): w = sum(dist/order) along the root path —
    WITHOUT the baseMSA `(int)(100*w)` truncation (commented out in the
    reference) — normalized to sum 1; an all-zero tree degenerates to
    uniform 1/numSeqs."""
    if num_seqs == 1:
        return np.array([1.0], dtype=np.float64)
    order: dict[int, int] = {}

    def count(node: TreeNode) -> int:
        c = 1 if node.leaf else count(node.left) + count(node.right)
        order[id(node)] = c
        return c

    count(root)
    weights = np.zeros(num_seqs, dtype=np.float64)

    def walk(node: TreeNode, acc: float):
        acc = acc + (node.dist / order[id(node)] if order[id(node)] else 0.0)
        if node.leaf:
            weights[node.idx] = acc
        else:
            walk(node.left, acc)
            walk(node.right, acc)

    if not root.leaf:
        walk(root.left, 0.0)
        walk(root.right, 0.0)
    # float32 accumulation order in the reference: sum as f32
    wsum = float(np.float32(weights.astype(np.float32).sum()))
    if wsum == 0.0:
        return np.full(num_seqs, 1.0 / num_seqs)
    return weights / wsum


def clustalw_weights(root: TreeNode, num_seqs: int) -> np.ndarray:
    """Integer ClustalW-style weights, int(100 * sum(dist/order))."""
    if num_seqs == 1:
        return np.array([100], dtype=np.int64)
    # order = number of leaves under each node
    order: dict[int, int] = {}

    def count(node: TreeNode) -> int:
        c = 1 if node.leaf else count(node.left) + count(node.right)
        order[id(node)] = c
        return c

    count(root)
    weights = np.zeros(num_seqs, dtype=np.int64)

    def walk(node: TreeNode, acc_terms: list[tuple[float, int]]):
        terms = acc_terms + [(node.dist, order[id(node)])]
        if node.leaf:
            w = sum(dist / o for dist, o in terms if o)
            # reference accumulates dist/order only while parent exists;
            # the root contributes nothing (dist 0 anyway)
            weights[node.idx] = int(100 * w)
        else:
            walk(node.left, terms)
            walk(node.right, terms)

    if root.leaf:
        weights[root.idx] = 0
    else:
        walk(root.left, [])
        walk(root.right, [])
    # integer renormalization (MSAGuideTree.cpp:303-319): all-zero ->
    # uniform 1s; then w = (w * INT_MULTIPLY) // wsum clamped to >= 1.
    # Without this, tight trees truncate most weights to 0 and the
    # profile weighting degenerates (w1*w2/totalWeights becomes 0/0).
    wsum = int(weights.sum())
    if wsum == 0:
        weights[:] = 1
        wsum = num_seqs
    weights = (weights * 1000) // wsum
    weights[weights < 1] = 1
    return weights
