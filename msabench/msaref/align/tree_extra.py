# Frozen copy of mlprobs_tpu_torch/align/tree_extra.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Additional guide-tree machinery from the QuickProbs layer.

* `slink` — single-linkage guide tree (SLinkTree.cpp / SingleLinkage).
* `chained` — degenerate left-to-right chain tree (TreeKind::Chained,
  ExtendedMSA.cpp:88-99 with degenerateDistances).
* `to_newick` — Newick serialisation (NewickTree.cpp export role).
* `subtree_distances` — per-pair distance in tree edges, the input of
  QuickProbs' Subtree selectivity mode (GuideTree.h:13-40).
"""
from __future__ import annotations

import numpy as np

from msabench.msaref.align.tree import TreeNode


def slink(distances: np.ndarray) -> TreeNode:
    """Single-linkage agglomerative tree over a distance matrix."""
    n = distances.shape[0]
    if n == 1:
        return TreeNode(idx=0)
    d = distances.astype(np.float64).copy()
    np.fill_diagonal(d, np.inf)
    nodes: list[TreeNode | None] = [TreeNode(idx=i) for i in range(n)]
    active = list(range(n))
    next_id = n
    while len(active) > 1:
        sub = d[np.ix_(active, active)]
        flat = int(np.argmin(sub))
        a, b = divmod(flat, len(active))
        if a > b:
            a, b = b, a
        ia, ib = active[a], active[b]
        parent = TreeNode(idx=next_id, leaf=False,
                          left=nodes[ia], right=nodes[ib])
        half = float(sub[a, b]) * 0.5
        nodes[ia].parent = nodes[ib].parent = parent
        nodes[ia].dist = nodes[ib].dist = half
        next_id += 1
        # single linkage: min distance to either member
        for k in active:
            if k not in (ia, ib):
                nd = min(d[ia, k], d[ib, k])
                d[ia, k] = d[k, ia] = nd
        nodes[ia] = parent
        active.remove(ib)
    return nodes[active[0]]


def chained(num_seqs: int) -> TreeNode:
    """Degenerate chain tree: ((((0,1),2),3)...)."""
    node = TreeNode(idx=0)
    for i in range(1, num_seqs):
        leaf = TreeNode(idx=i)
        parent = TreeNode(idx=num_seqs + i - 1, leaf=False,
                          left=node, right=leaf)
        node.parent = leaf.parent = parent
        node = parent
    return node


def to_newick(node: TreeNode, names: list[str] | None = None) -> str:
    def fmt(t: TreeNode) -> str:
        if t.leaf:
            label = names[t.idx] if names else str(t.idx)
            return f"{label}:{t.dist:.6g}"
        return f"({fmt(t.left)},{fmt(t.right)}):{t.dist:.6g}"

    return fmt(node) + ";"


def subtree_distances(root: TreeNode, num_seqs: int) -> np.ndarray:
    """Pairwise leaf distances in tree-edge counts."""
    # path to root for each leaf
    paths: dict[int, list[int]] = {}

    def walk(node: TreeNode, trail: list[int]):
        trail = trail + [id(node)]
        if node.leaf:
            paths[node.idx] = trail
        else:
            walk(node.left, trail)
            walk(node.right, trail)

    walk(root, [])
    out = np.zeros((num_seqs, num_seqs))
    for i in range(num_seqs):
        for j in range(i + 1, num_seqs):
            pi, pj = paths[i], paths[j]
            common = 0
            for a, b in zip(pi, pj):
                if a == b:
                    common += 1
                else:
                    break
            dist = (len(pi) - common) + (len(pj) - common)
            out[i, j] = out[j, i] = dist
    return out


def parse_newick(text: str, names: list[str] | None = None) -> TreeNode:
    """Parse a Newick description into a TreeNode tree.

    The import side of the reference's NewickTree/TreeGrammar
    (NewickTree.cpp:16-31, TreeGrammar.h): leaf labels are either
    indices or names resolved through `names`; branch lengths become
    TreeNode.dist.  Multifurcations are resolved left-associatively
    (the reference grammar only accepts binary trees; we are more
    lenient).
    """
    pos = [0]
    s = text.strip()
    if s.endswith(";"):
        s = s[:-1]
    name_to_idx = (
        {n: i for i, n in enumerate(names)} if names is not None else None
    )
    next_internal = [0]

    def peek():
        return s[pos[0]] if pos[0] < len(s) else ""

    def parse_label() -> str:
        start = pos[0]
        while pos[0] < len(s) and s[pos[0]] not in ",():;":
            pos[0] += 1
        return s[start: pos[0]]

    def parse_node() -> TreeNode:
        if peek() == "(":
            pos[0] += 1  # (
            children = [parse_node()]
            while peek() == ",":
                pos[0] += 1
                children.append(parse_node())
            if peek() != ")":
                raise ValueError(f"unbalanced newick at {pos[0]}")
            pos[0] += 1  # )
            parse_label()  # optional internal label, ignored
            node = children[0]
            for ch in children[1:]:
                parent = TreeNode(idx=-1, leaf=False, left=node, right=ch)
                node.parent = ch.parent = parent
                node = parent
        else:
            label = parse_label()
            if name_to_idx is not None:
                if label not in name_to_idx:
                    raise ValueError(f"unknown leaf {label!r}")
                idx = name_to_idx[label]
            else:
                idx = int(label)
            node = TreeNode(idx=idx)
        if peek() == ":":
            pos[0] += 1
            start = pos[0]
            while pos[0] < len(s) and s[pos[0]] not in ",():;":
                pos[0] += 1
            node.dist = float(s[start: pos[0]])
        return node

    root = parse_node()
    if pos[0] != len(s):
        raise ValueError(f"trailing newick input at {pos[0]}")

    # assign internal ids in post-order after the leaf ids
    n_leaves = sum(1 for _ in leaves_iter(root))
    counter = [n_leaves]

    def number(t: TreeNode):
        if not t.leaf:
            number(t.left)
            number(t.right)
            t.idx = counter[0]
            counter[0] += 1

    number(root)
    return root


def leaves_iter(node: TreeNode):
    if node.leaf:
        yield node
    else:
        yield from leaves_iter(node.left)
        yield from leaves_iter(node.right)


def parse_phylip_tree(text: str, names: list[str] | None = None) -> TreeNode:
    """Phylip tree files are Newick with optional leading whitespace /
    line wraps (PhylipTree.cpp role)."""
    return parse_newick("".join(text.split()), names)
