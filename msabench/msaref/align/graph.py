# Frozen copy of mlprobs_tpu_torch/align/graph.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Non-progressive alignment graph (PicXAA lineage).

Reference: baseMSA AlignGraph.h.  Sparse posterior cells are visited in
descending probability; each residue pair is added to a DAG of alignment
columns via one of three operations -- new node, column extension, column
merge -- each guarded by ancestor/descendant cycle checks; the final DAG
is linearised into alignment columns (Graph2Align/Path2Align).

Host code, as in the JAX package (mlprobs_tpu/align/graph.py): the
insertion is sequential and pointer-heavy.  Ancestor and descendant sets
are numpy bool matrices so closure updates are vectorised.  The cell
order is the result: cells are sorted by descending probability with
ties kept in the order of the posts dict and, within a pair, of its CSR
storage, as the JAX package's stable sort keeps them.
"""
from __future__ import annotations

import heapq

import numpy as np

from msabench.msaref.core.msa import MSA


class AlignGraph:
    def __init__(self, num_seqs: int, seq_lengths: list[int]):
        self.num_seqs = num_seqs
        self.lengths = seq_lengths
        # children adjacency (list of lists), node count
        self.children: list[list[int]] = []
        # present[i][j] = node id of residue j of sequence i, or -1
        self.present = [np.full(l, -1, dtype=np.int64)
                        for l in seq_lengths]
        # ancs[i, j] = node j is an ancestor of node i (and transposed)
        self.ancs = np.zeros((0, 0), dtype=bool)
        self.descs = np.zeros((0, 0), dtype=bool)
        self.dead: set[int] = set()   # nodes merged into another

    # -------------------------------------------------------------- helpers
    def _grow(self) -> int:
        """Append an empty node; returns its id."""
        n = len(self.children)
        self.children.append([])
        if self.ancs.shape[0] <= n:
            grow = max(64, n)
            na = np.zeros((n + grow, n + grow), dtype=bool)
            na[: self.ancs.shape[0], : self.ancs.shape[1]] = self.ancs
            self.ancs = na
            nd = np.zeros((n + grow, n + grow), dtype=bool)
            nd[: self.descs.shape[0], : self.descs.shape[1]] = self.descs
            self.descs = nd
        return n

    def _close_nodes(self, seq: int, pos: int) -> tuple[int, int]:
        """Nearest preceding/succeeding node ids in this sequence (-1 none)."""
        row = self.present[seq]
        parent = -1
        for i in range(pos - 1, -1, -1):
            if row[i] != -1:
                parent = int(row[i])
                break
        child = -1
        for i in range(pos + 1, len(row)):
            if row[i] != -1:
                child = int(row[i])
                break
        return parent, child

    def _propagate(self, node: int):
        """Transitive-closure update around `node` (reference AA/DD loops)."""
        n = len(self.children)
        aa = np.flatnonzero(self.ancs[node, :n])
        dd = np.flatnonzero(self.descs[node, :n])
        if dd.size:
            self.ancs[dd, node] = True
            if aa.size:
                self.ancs[np.ix_(dd, aa)] = True
                self.descs[np.ix_(aa, dd)] = True
        if aa.size:
            self.descs[aa, node] = True

    # ------------------------------------------------------------ new node
    def try_new_node(self, x, y) -> bool:
        px, cx = self._close_nodes(*x)
        py, cy = self._close_nodes(*y)
        parents = sorted({p for p in (px, py) if p != -1})
        children = sorted({c for c in (cx, cy) if c != -1})

        ok = True
        if px != -1 and cy != -1:
            ok = ok and not self.descs[cy, px] and px != cy
        if py != -1 and cx != -1:
            ok = ok and not self.descs[cx, py] and py != cx
        if not ok:
            return False

        new = self._grow()
        self.children[new] = list(children)
        for p in parents:
            self.children[p].append(new)

        # remove redundant direct edges
        if px != -1 and py != -1:
            if self.descs[px, py]:
                self._remove_edge(px, new)
            if self.descs[py, px]:
                self._remove_edge(py, new)
        if cx != -1 and cy != -1:
            if self.descs[cx, cy]:
                self._remove_edge(new, cy)
            if self.descs[cy, cx]:
                self._remove_edge(new, cx)
        for p in parents:
            for c in children:
                self._remove_edge(p, c)

        self.present[x[0]][x[1]] = new
        self.present[y[0]][y[1]] = new

        # ancestors/descendants of the new node
        for p in parents:
            self.ancs[new] |= self.ancs[p]
            self.ancs[new, p] = True
        for c in children:
            self.descs[new] |= self.descs[c]
            self.descs[new, c] = True
        self._propagate(new)
        return True

    def _remove_edge(self, a: int, b: int):
        try:
            self.children[a].remove(b)
        except ValueError:
            pass

    # ------------------------------------------------------- column extend
    def try_extend(self, y, node: int) -> bool:
        # immediate cycle check: node already holds a residue of y's seq
        if (self.present[y[0]] == node).any():
            return False
        py, cy = self._close_nodes(*y)

        ok = True
        if cy != -1:
            ok = ok and not self.descs[cy, node] and cy != node
        if py != -1:
            ok = ok and not self.descs[node, py] and py != node
        if not ok:
            return False

        if py != -1 and node not in self.children[py]:
            self.children[py].append(node)
        if cy != -1 and cy not in self.children[node]:
            self.children[node].append(cy)

        # redundant direct edge (transitive reduction, reference :549-559)
        if py != -1 and cy != -1 and cy in self.children[py]:
            self._remove_edge(py, cy)
        self.present[y[0]][y[1]] = node
        if py != -1:
            self.ancs[node] |= self.ancs[py]
            self.ancs[node, py] = True
        if cy != -1:
            self.descs[node] |= self.descs[cy]
            self.descs[node, cy] = True
        self._propagate(node)
        return True

    # -------------------------------------------------------- column merge
    def try_merge(self, cx: int, cy: int, x, y) -> bool:
        if (self.present[y[0]] == cx).any():
            return False
        if (self.present[x[0]] == cy).any():
            return False
        if cx > cy:
            cx, cy = cy, cx
        if self.descs[cx, cy] or self.descs[cy, cx]:
            return False

        n = len(self.children)
        # merged children: union minus self-reference
        merged = sorted(set(self.children[cx]) | set(self.children[cy]))
        merged = [c for c in merged if c not in (cx, cy)]
        # rewire every parent edge of cy to cx
        for j in range(n):
            if j in (cx, cy):
                continue
            ch = self.children[j]
            if cy in ch:
                ch.remove(cy)
                if cx not in ch:
                    ch.append(cx)
        self.children[cx] = merged
        self.children[cy] = []

        # merge closure rows; cy becomes an alias of cx
        self.ancs[cx] |= self.ancs[cy]
        self.descs[cx] |= self.descs[cy]
        self.ancs[:n, cx] |= self.ancs[:n, cy]
        self.descs[:n, cx] |= self.descs[:n, cy]
        self.ancs[cy] = False
        self.descs[cy] = False
        self.ancs[:n, cy] = False
        self.descs[:n, cy] = False
        self.ancs[cx, cx] = False
        self.descs[cx, cx] = False

        # transitive-reduction cleanup: drop direct edges that are implied
        for p in np.flatnonzero(self.ancs[cx, :n]):
            for d in np.flatnonzero(self.descs[cx, :n]):
                if d in self.children[p]:
                    self._remove_edge(int(p), int(d))

        # relabel cy -> cx in present
        for i in range(self.num_seqs):
            row = self.present[i]
            row[row == cy] = cx
        self.dead.add(cy)
        self._propagate(cx)
        return True

    # --------------------------------------------------------- linearise
    def build(self, a, i, b, j):
        """Insert the cells (a[k], i[k]) ~ (b[k], j[k]), already sorted by
        descending probability."""
        for a_, i_, b_, j_ in zip(a.tolist(), i.tolist(), b.tolist(),
                                  j.tolist()):
            nx = int(self.present[a_][i_])
            ny = int(self.present[b_][j_])
            if nx == -1 and ny == -1:
                self.try_new_node((a_, i_), (b_, j_))
            elif (nx == -1) != (ny == -1):
                if nx != -1:
                    self.try_extend((b_, j_), nx)
                else:
                    self.try_extend((a_, i_), ny)
            elif nx != ny:
                self.try_merge(nx, ny, (a_, i_), (b_, j_))

    def live_nodes(self) -> list[int]:
        return [i for i in range(len(self.children)) if i not in self.dead]

    def linearise(self) -> list[int]:
        """Graph2Align path construction (AddtoPath insertion semantics).

        The reference recurses once a node; an explicit stack visits the
        children in the same order, so a graph of tens of thousands of
        nodes needs no deep recursion."""
        live = self.live_nodes()
        has_parent = set()
        for i in live:
            for c in self.children[i]:
                has_parent.add(c)
        roots = [i for i in live if i not in has_parent]
        path: list[int] = []
        marked = set(self.dead)

        def add_to_path(n1: int, n2: int):
            h = -1 if n1 == -1 else path.index(n1)
            path.insert(h + 1, n2)

        for r in roots:
            add_to_path(-1, r)
            stack = [(r, 0)]
            while stack:
                node, k = stack[-1]
                ch = self.children[node]
                while k < len(ch) and ch[k] in marked:
                    k += 1
                if k == len(ch):
                    stack.pop()
                    continue
                c = ch[k]
                stack[-1] = (node, k + 1)
                marked.add(c)
                add_to_path(node, c)
                stack.append((c, 0))
        if self._order_valid(path):
            return path
        # fall back to a plain Kahn topological sort: the reference's
        # insert-after-parent heuristic can (rarely) order incomparable
        # nodes against a sequence's residue order.
        return self._topo_sort(live)

    def _order_valid(self, path: list[int]) -> bool:
        pos = {node: k for k, node in enumerate(path)}
        for i in range(self.num_seqs):
            row = self.present[i]
            last = -1
            for j in range(self.lengths[i]):
                if row[j] != -1:
                    p = pos.get(int(row[j]))
                    if p is None or p < last:
                        return False
                    last = p
        return True

    def _topo_sort(self, live: list[int]) -> list[int]:
        # order constraints: graph edges + per-sequence residue order
        succ: dict[int, set[int]] = {i: set(self.children[i]) for i in live}
        for i in range(self.num_seqs):
            row = self.present[i]
            prev = -1
            for j in range(self.lengths[i]):
                if row[j] != -1:
                    node = int(row[j])
                    if prev != -1 and node != prev:
                        succ[prev].add(node)
                    prev = node
        indeg = {i: 0 for i in live}
        for i in live:
            for c in succ[i]:
                indeg[c] += 1
        ready = sorted([i for i in live if indeg[i] == 0])
        out = []
        heapq.heapify(ready)
        while ready:
            i = heapq.heappop(ready)
            out.append(i)
            for c in succ[i]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    heapq.heappush(ready, c)
        return out

    def to_alignment(self, msa: MSA) -> MSA:
        """Path2Align: emit columns + single-residue columns."""
        path = self.linearise()
        pos_in_path = {node: k for k, node in enumerate(path)}
        # residues per node
        cols: dict[int, list[tuple[int, int]]] = {node: [] for node in path}
        # single-residue columns: after which path position?
        src: dict[int, list[tuple[int, int]]] = {}
        zero_pos: list[tuple[int, int]] = []
        for i in range(self.num_seqs):
            row = self.present[i]
            for j in range(self.lengths[i]):
                node = int(row[j])
                if node != -1:
                    cols[node].append((i, j))
                else:
                    ct = j - 1
                    anchor = None
                    while ct >= 0:
                        if row[ct] != -1:
                            anchor = pos_in_path[int(row[ct])]
                            break
                        ct -= 1
                    if anchor is None:
                        zero_pos.append((i, j))
                    else:
                        src.setdefault(anchor, []).append((i, j))

        out_cols: list[np.ndarray] = []
        seqs = msa.ungapped()

        def single_col(i, j):
            col = np.full(self.num_seqs, -1, dtype=np.int8)
            col[i] = seqs[i][j]
            return col

        for (i, j) in zero_pos:
            out_cols.append(single_col(i, j))
        for k, node in enumerate(path):
            col = np.full(self.num_seqs, -1, dtype=np.int8)
            for (i, j) in cols[node]:
                col[i] = seqs[i][j]
            out_cols.append(col)
            for (i, j) in src.get(k, []):
                out_cols.append(single_col(i, j))
        rows = (
            np.stack(out_cols, axis=1)
            if out_cols
            else np.zeros((self.num_seqs, 0), np.int8)
        )
        return MSA(headers=list(msa.headers), rows=rows,
                   labels=msa.labels.copy())


def sorted_cells(posts: dict) -> tuple[np.ndarray, ...]:
    """(a, i, b, j, p) of every posterior cell, by descending p.

    The cells are concatenated in the order of `posts` and, within a
    pair, of its COO view of the CSR storage; the stable sort keeps that
    order among equal p, as the JAX package's list sort does."""
    parts = [[], [], [], [], []]
    for (a, b), s in posts.items():
        coo = s.tocoo()
        k = coo.nnz
        parts[0].append(np.full(k, a, np.int64))
        parts[1].append(coo.row.astype(np.int64))
        parts[2].append(np.full(k, b, np.int64))
        parts[3].append(coo.col.astype(np.int64))
        parts[4].append(coo.data.astype(np.float64))
    if not parts[0]:
        return tuple(np.zeros(0, np.int64) for _ in range(4)) + (
            np.zeros(0),)
    a, i, b, j, p = (np.concatenate(x) for x in parts)
    order = np.argsort(-p, kind="stable")
    return a[order], i[order], b[order], j[order], p[order]


def graph_align(msa: MSA, posts: dict, seqs: list[np.ndarray],
                report: dict | None = None) -> MSA:
    """Build the alignment graph from sparse posteriors and linearise.
    `report`, when given, records the cells inserted and the graph's
    live nodes."""
    a, i, b, j, _ = sorted_cells(posts)
    g = AlignGraph(msa.num_seqs, [len(s) for s in seqs])
    g.build(a, i, b, j)
    if report is not None:
        report["graph_cells"] = int(len(a))
        report["graph_nodes"] = len(g.live_nodes())
    return g.to_alignment(msa)
