"""Probabilistic-consistency transform.

Reference: MSA::DoRelaxation (MSA.cpp:1172-1281):

    P'(x,y) = (2 P(x,y) + sum_{z != x,y} P(x,z) P(z,y)) / N

masked to the original sparsity support and re-thresholded at 0.01.

* `relax_packed_rounds` (device, the main path): the same update on the
  tensor packed by true lengths into one (T x T) block matrix
  (`Packing`, T = sum(L) rounded per block), the pairs i < j only, as a
  staircase of f32 products over row panels; R_ji = R_ij^T is mirrored.
* `relax_dense_rounds` (device): the contraction over a dense zero-diagonal
  (N, N, Lp, Lp) posterior tensor, one f32 einsum per round (a plain large
  product, left to the library as the JAX package left it to XLA); the
  yardstick and the reference of the sharded route.
* `relax_sparse` (host): one product of the (sum(L) x sum(L)) block matrix
  Q with identity diagonal blocks — Q^2 block (i,j) is exactly
  2 P_ij + sum_z P_iz P_zj.  scipy CSR; the path of families with fewer
  than three sequences and of the recorded device downgrades.
* `relax_sparse_weighted` (host): the QuickProbs weighted transform, with
  the stochastic selectivity filter (`z_acceptance`) or accept-all;
  scipy CSR, the realigner's host path.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import torch

from mlprobs_tpu_torch.utils import qprand
from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS

CUTOFF = 0.01  # SparseMatrix.h:14
# a block of the packed matrix starts on a multiple of 8 floats (32 bytes),
# so that every GEMM operand cut from it is aligned
PACK_ALIGN = 8
# a GEMM of the relaxation's staircase takes row blocks until it has this
# many rows: narrower panels cost more in launches than a wider one wastes
# on the blocks below the diagonal inside it (an H100 at N = 48 of 330-470
# residues: panels of 1, 4, 8 and 47 blocks took 353, 346, 362 and 662 ms
# a relaxation; at N = 4 one panel of 3 blocks 1.35 ms, 3 panels 2.08 ms)
PANEL_ROWS = 1536

# Park-Miller minimal standard generator: the deterministic RNG the
# reference uses identically on host and device so CPU/GPU runs match
# (Common/deterministic_random.h, Kernels/Random.cl).
PM_MOD = 2147483647
PM_MULT = 16807


def parkmiller(seed: int) -> int:
    return (seed * PM_MULT) % PM_MOD


SELECTIVITY_FUNCTIONS = {
    "sum": lambda x, y: x + y,
    "min": min,
    "max": max,
    "avg": lambda x, y: x + y / 2,   # the reference's literal formula
}


def selectivity_filter(kind: str, selectivity: float):
    """Filter shape + coefficients (ConsistencyStage.cpp:35-58)."""
    if kind == "deterministic":
        a = selectivity
        return lambda x: 2.0 if x <= a else 0.0
    if kind == "triangle_lowpass":
        a = -1.0
        b = math.sqrt(2.0 * selectivity * (-a))
        return lambda x: a * x + b
    if kind == "triangle_highpass":
        a = 1.0
        b = -1 + math.sqrt(2.0 * selectivity * a)
        return lambda x: a * x + b
    if kind == "triangle_midpass":
        a = 4 * selectivity
        return lambda x: min(a * x, -a * x + a)
    if kind == "homograph_lowpass":
        a = selectivity
        return lambda x: (1 - x) / (a * x + 1)
    raise ValueError(kind)


def z_acceptance(
    distances: np.ndarray,
    i: int,
    j: int,
    seed: int,
    function: str = "max",
    filter_kind: str = "deterministic",
    selectivity: float = 200.0,
) -> list[int]:
    """Accepted intermediate sequences z for pair (i, j).

    Reference-exact stochastic z-filter (ConsistencyStage.cpp:186-221):
    the pair's mt19937-table seed drives the 75-multiplier Lehmer
    stream; z is accepted iff float(seed) * RND_MAX_INV < filter(x).
    `seed` must come from qprand.consistency_seed_matrix.
    """
    n = distances.shape[0]
    func = SELECTIVITY_FUNCTIONS[function]
    filt = selectivity_filter(filter_kind, selectivity)
    zs = [k for k in range(n) if k not in (i, j)]
    x = np.array(
        [filt(func(distances[i, k], distances[j, k])) for k in zs],
        dtype=np.float32,
    )
    accept = qprand.z_accept_row(seed, x)
    return [k for k, a in zip(zs, accept) if a]


def selectivity_distances(
    mode: str,
    distances: np.ndarray,
    subtree: np.ndarray | None = None,
    selectivity: float = 200.0,
    normalization: str = "no",
) -> np.ndarray:
    """Consistency-distance preparation (ExtendedMSA.cpp:104-177).

    mode: "subtree" (tree subtree distances), "similarity" (the MWT
    distance matrix) or "seed" (all-max matrix with `selectivity`
    mt19937-drawn seed rows zeroed).  normalization: "no", "stochastic"
    (divide by max if > 1), "ranked" (global stable rank desc over all
    n*n entries, / n(n-1), diag preset to max) or "rankedrow" (row-wise
    rank desc / n).
    """
    n = distances.shape[0]
    if mode == "subtree":
        if subtree is None:
            raise ValueError("subtree mode needs subtree distances")
        cd = np.array(subtree, dtype=np.float32, copy=True)
    elif mode == "similarity":
        cd = np.array(distances, dtype=np.float32, copy=True)
    elif mode == "seed":
        cd = np.full((n, n), np.finfo(np.float32).max, np.float32)
        for s in qprand.seed_selection_ids(n, int(selectivity)):
            cd[s, :] = 0.0
            cd[:, s] = 0.0
    else:
        raise ValueError(mode)

    def rank_desc(flat: np.ndarray) -> np.ndarray:
        # rank_range with std::greater: stable sort ascending by
        # (value, index) under >, i.e. descending value, stable
        order = np.lexsort((np.arange(len(flat)), -flat))
        out = np.empty(len(flat), dtype=np.float32)
        out[order] = np.arange(len(flat), dtype=np.float32)
        return out

    if normalization == "no":
        pass
    elif normalization == "stochastic":
        mx = cd.max()
        if mx > 1.0:
            cd = cd / mx
    elif normalization == "ranked":
        np.fill_diagonal(cd, np.finfo(np.float32).max)
        cd = rank_desc(cd.ravel()).reshape(n, n) / (n * (n - 1))
    elif normalization == "rankedrow":
        np.fill_diagonal(cd, np.finfo(np.float32).max)
        cd = np.stack([rank_desc(row) for row in cd]) / n
    else:
        raise ValueError(normalization)
    return cd.astype(np.float32)


def saturate_weights(weights: np.ndarray,
                     saturation: float = 1e-6) -> np.ndarray:
    """Weight saturation clamp (ExtendedMSA.cpp:178,184)."""
    return np.maximum(np.asarray(weights, np.float64), saturation)


def sparsify(post: np.ndarray, cutoff: float = CUTOFF) -> sp.csr_matrix:
    """Threshold a dense posterior plane into CSR (values >= cutoff)."""
    keep = post >= cutoff
    out = sp.csr_matrix(np.where(keep, post, 0.0))
    out.eliminate_zeros()
    return out


def _block_matrix(
    posts: dict[tuple[int, int], sp.csr_matrix], lengths: list[int]
) -> sp.csr_matrix:
    n = len(lengths)
    blocks: list[list] = [[None] * n for _ in range(n)]
    for i in range(n):
        blocks[i][i] = sp.identity(lengths[i], format="csr")
    for (i, j), s in posts.items():
        blocks[i][j] = s
        blocks[j][i] = s.T.tocsr()
    return sp.bmat(blocks, format="csr")


def relax_sparse(
    posts: dict[tuple[int, int], sp.csr_matrix],
    lengths: list[int],
    reps: int = 2,
    cutoff: float = CUTOFF,
) -> dict[tuple[int, int], sp.csr_matrix]:
    """`reps` rounds of the consistency transform on CSR posteriors."""
    n = len(lengths)
    offs = np.concatenate([[0], np.cumsum(lengths)])
    current = posts
    for _ in range(reps):
        q = _block_matrix(current, lengths)
        r = (q @ q) / n
        # mask to the original off-diagonal support
        pattern = _block_matrix(current, lengths)
        pattern.setdiag(0)
        pattern.eliminate_zeros()
        pattern.data[:] = 1.0
        r = r.multiply(pattern).tocsr()
        r.data[r.data < cutoff] = 0.0
        r.eliminate_zeros()
        new = {}
        for (i, j) in current:
            blk = r[offs[i] : offs[i + 1], offs[j] : offs[j + 1]].tocsr()
            new[(i, j)] = blk
        current = new
    return current


def relax_sparse_weighted(
    posts: dict[tuple[int, int], sp.csr_matrix],
    lengths: list[int],
    weights: np.ndarray,
    reps: int = 2,
    selfweight: float = 3.0,
    selectivity: float = 200.0,
    cutoff: float = CUTOFF,
    distances: np.ndarray | None = None,
    final_cutoff: float | None = None,
) -> dict[tuple[int, int], sp.csr_matrix]:
    """QuickProbs-style weighted relaxation (ConsistencyStage.cpp:133-259).

    P'_ij = (P_ij + sum_{z in A_ij} (w_z / W_ij) P_iz P_zj) / sumW_ij
    with W_ij = (1 + (selfweight-1) * |A_ij|/selectivity) * (w_i + w_j),
    masked to the original support and re-thresholded.  A_ij is the
    accepted-z set of the stochastic selectivity filter; when
    `distances` is None every z is accepted (the deterministic filter
    below its threshold — the realign-block regime), enabling the
    single-block-product path.
    """
    if final_cutoff is not None and final_cutoff != cutoff and reps > 0:
        # numFilterings=-1: the last iteration re-sparsifies at 1e-5
        # (ConsistencyStage.cpp:230-259); run it as its own round
        if reps > 1:
            posts = relax_sparse_weighted(
                posts, lengths, weights, reps=reps - 1,
                selfweight=selfweight, selectivity=selectivity,
                cutoff=cutoff, distances=distances,
            )
        return relax_sparse_weighted(
            posts, lengths, weights, reps=1, selfweight=selfweight,
            selectivity=selectivity, cutoff=final_cutoff,
            distances=distances,
        )
    n = len(lengths)
    offs = np.concatenate([[0], np.cumsum(lengths)])
    w = np.asarray(weights, dtype=np.float64)
    current = posts
    accept_all = distances is None
    seeds = None if accept_all else qprand.consistency_seed_matrix(n)

    for _ in range(reps):
        blocks: list[list] = [[None] * n for _ in range(n)]
        for (i, j), s in current.items():
            blocks[i][j] = s
            blocks[j][i] = s.T.tocsr()
        if accept_all:
            # block matrix with ZERO diagonal (self terms added explicitly)
            q = sp.bmat(blocks, format="csr")
            wdiag = sp.diags(
                np.concatenate(
                    [np.full(lengths[z], w[z]) for z in range(n)]
                )
            )
            r = q @ wdiag @ q
        new = {}
        for (i, j), s in current.items():
            if accept_all:
                accepted = [z for z in range(n) if z not in (i, j)]
            else:
                accepted = z_acceptance(
                    distances, i, j, seed=int(seeds[i, j]),
                    selectivity=selectivity,
                )
            wij = (1.0 + (selfweight - 1.0) * len(accepted) / selectivity)
            wij *= w[i] + w[j]
            sum_w = 1.0 + sum(w[z] for z in accepted) / wij
            if accept_all:
                blk = r[offs[i]:offs[i + 1], offs[j]:offs[j + 1]].tocsr()
            else:
                blk = sp.csr_matrix((lengths[i], lengths[j]))
                for z in accepted:
                    blk = blk + w[z] * (blocks[i][z] @ blocks[z][j])
            out = (s + blk / wij) / sum_w
            out = out.multiply(s > 0).tocsr()
            out.data[out.data < cutoff] = 0.0
            out.eliminate_zeros()
            new[(i, j)] = out
        current = new
    return current


# Both reference transforms reduce to one parametrised update on a dense
# (N, N, Lp, Lp) posterior tensor S with ZERO diagonal blocks (S_ii = 0
# makes the z != i, j exclusion automatic):
#
#   R_ij = self_coef[i,j] * S_ij + z_scale[i,j] * sum_z w[z] * S_iz @ S_zj
#
# masked to support(S_ij >= cutoff) and re-thresholded.
#
#   baseMSA DoRelaxation (MSA.cpp:1172-1281):
#       self_coef = 2/N, z_scale = 1/N, w = 1
#   QuickProbs weighted accept-all (ConsistencyStage.cpp:133-259):
#       wij = (1 + (sw-1)(N-2)/sel) * (w_i + w_j)
#       sumW = 1 + (sum(w) - w_i - w_j)/wij
#       self_coef = 1/sumW, z_scale = 1/(wij * sumW), w = weights


def dense_relax_coeffs(
    n: int,
    weights: np.ndarray | None = None,
    selfweight: float = 3.0,
    selectivity: float = 200.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(self_coef (N,N), z_scale (N,N), w (N,)) for relax_dense_rounds."""
    if weights is None:
        sc = np.full((n, n), 2.0 / n, np.float32)
        zs = np.full((n, n), 1.0 / n, np.float32)
        return sc, zs, np.ones(n, np.float32)
    w = np.asarray(weights, np.float64)
    wi = w[:, None] + w[None, :]
    wij = (1.0 + (selfweight - 1.0) * (n - 2) / selectivity) * wi
    sum_w = 1.0 + (w.sum() - wi) / wij
    return (
        (1.0 / sum_w).astype(np.float32),
        (1.0 / (wij * sum_w)).astype(np.float32),
        w.astype(np.float32),
    )


def relax_dense_rounds(S, self_coef, z_scale, w, reps: int = 2,
                       cutoff: float = CUTOFF,
                       final_cutoff: float | None = None):
    """`reps` relaxation rounds on a zero-diagonal (N, N, Lp, Lp) tensor.

    The z-contraction is one weighted f32 einsum per round; the support
    mask and threshold follow each round (the reference masks to the
    round's input sparsity pattern, MSA.cpp:1237-1261).  `final_cutoff`
    is the LAST round's re-threshold (QuickProbs' numFilterings=-1,
    ConsistencyStage.cpp:230-259).  TF32 stays off: the reference
    contracts in full f32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    for it in range(reps):
        c = cutoff if (final_cutoff is None or it < reps - 1) \
            else final_cutoff
        prod = torch.einsum("izab,z,zjbc->ijac", S, w, S)
        r = (self_coef[:, :, None, None] * S
             + z_scale[:, :, None, None] * prod)
        del prod
        S = torch.where((S > 0) & (r >= c), r, 0.0)
    return S


class Packing:
    """Where each sequence's rows and columns lie in the packed (T x T)
    block matrix of a family: block i starts at `offs[i]`, spans L_i
    rounded up to PACK_ALIGN, and holds S[i, j, :L_i, :L_j] against block
    j; the rows and columns past L_i are zero, and so are the diagonal
    blocks.  `unpack` gives back the (Lp x Lp) planes of `pairs`, in
    order.  The index tensors go to `device` here, before any round is
    enqueued (a copy from the host waits for the stream), and each is
    one-dimensional: advanced indices that broadcast against each other
    are expanded in memory, (T, T) or (pairs, Lp, Lp) int64s."""

    def __init__(self, seq_lens, pairs, lp: int, device):
        lens = np.asarray(seq_lens, np.int64)
        sizes = -(-lens // PACK_ALIGN) * PACK_ALIGN
        self.lens, self.lp = lens, lp
        self.offs = np.concatenate([[0], np.cumsum(sizes)])
        self.side = int(self.offs[-1])
        # the block of each packed column and the position in it
        block = np.repeat(np.arange(len(lens)), sizes)
        pos = np.arange(self.side) - self.offs[block]
        blk_len = lens[block]
        # the pairs by their first sequence; the packed columns of each
        # pair's second block (clamped past L_j, where the plane is zero)
        ii = np.array([i for i, _ in pairs], np.int64)
        jj = np.array([j for _, j in pairs], np.int64)
        ar = np.arange(lp)
        self._groups = [(int(i), np.flatnonzero(ii == i))
                        for i in np.unique(ii)]

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self._blk = dev(block)
        self._pos = dev(np.minimum(pos, blk_len - 1))
        self._pad = dev(pos >= blk_len)
        self._ks = dev(np.concatenate([k for _, k in self._groups]))
        self._cols = dev(self.offs[jj][:, None]
                         + np.minimum(ar, lens[jj][:, None] - 1))
        self._pad_c = dev(ar >= lens[jj][:, None])

    def pack(self, S):
        """Q[offs[i] + a, offs[j] + b] = S[i, j, a, b] for a < L_i and
        b < L_j, zero elsewhere: a gather of each row block from the
        (N, N, Lp, Lp) tensor."""
        V = S.permute(0, 2, 1, 3)          # V[i, a, j, b] = S[i, j, a, b]
        Q = S.new_zeros((self.side, self.side))
        for i, lo in enumerate(self.offs[:-1]):
            li = int(self.lens[i])
            Q[lo:lo + li] = V[i, :li, self._blk, self._pos]
        Q.masked_fill_(self._pad, 0.0)
        return Q

    def unpack(self, R):
        """The (pairs, Lp, Lp) planes of the pairs' blocks (i, j) of R,
        zero past each pair's lengths: the dense tensor's S[ii, jj]
        layout."""
        lp = self.lp
        planes = R.new_zeros((len(self._cols), lp, lp))
        at = 0
        for i, ks in self._groups:
            lo, li = int(self.offs[i]), int(self.lens[i])
            k = self._ks[at:at + len(ks)]
            at += len(ks)
            src = R[lo:lo + li].index_select(1, self._cols[k].reshape(-1))
            planes[:, :li].index_copy_(
                0, k, src.view(li, len(ks), lp).transpose(0, 1))
        planes.masked_fill_(self._pad_c[:, None, :], 0.0)
        return planes


def _panels(offs):
    """(first, end) row blocks of each GEMM of the staircase: consecutive
    blocks until the panel holds PANEL_ROWS rows, the last block (no
    column right of it) left out."""
    n = len(offs) - 1
    i0 = 0
    while i0 < n - 1:
        i1 = i0 + 1
        while i1 < n - 1 and offs[i1] - offs[i0] < PANEL_ROWS:
            i1 += 1
        yield i0, i1
        i0 = i1


def relax_packed_rounds(Q, packing: Packing, self_coef, z_scale, w,
                        reps: int = 2, cutoff: float = CUTOFF,
                        final_cutoff: float | None = None):
    """`reps` rounds of `relax_dense_rounds`' update on the packed matrix
    Q (`Packing.pack`), computed for the blocks i < j only.

    The coefficients are symmetric (both depend on w_i + w_j) and so is
    the tensor (S_ji = S_ij^T), so R_ji = R_ij^T: a round multiplies each
    panel of row blocks by the columns right of its first block (the z
    sum runs over every block; Q's zero diagonal blocks add exact zeros,
    as in the dense einsum), applies the update, the support mask and the
    cutoff to that strip, and between rounds writes each row block's
    upper strip, transposed, below the diagonal.  After the last round
    the blocks below the diagonal are stale: only the upper ones are
    read.  f32 with TF32 off.  Q is overwritten; the counter `gemm_flops`
    gains 2 m n k of each product it runs.  Host arrays: `self_coef`,
    `z_scale` (N, N), `w` (N,)."""
    if not (np.array_equal(self_coef, self_coef.T)
            and np.array_equal(z_scale, z_scale.T)):
        raise ValueError("relaxation coefficients are not symmetric: the "
                         "upper blocks do not give the lower ones")
    torch.backends.cuda.matmul.allow_tf32 = False
    n = len(w)
    # one copy from the host: self_coef, z_scale, w
    coef = torch.from_numpy(np.concatenate(
        [self_coef.ravel(), z_scale.ravel(), w]).astype(np.float32)).to(
        Q.device)
    blk = packing._blk
    # (N, T): row block i's coefficient against each packed column
    sc = coef[:n * n].view(n, n)[:, blk]
    zs = coef[n * n:2 * n * n].view(n, n)[:, blk]
    wcol = None if np.all(w == 1.0) else coef[2 * n * n:][blk]
    out = torch.zeros_like(Q)
    flops = 0
    for it in range(reps):
        last = it == reps - 1
        c = final_cutoff if final_cutoff is not None and last else cutoff
        flops += _relax_round(Q, out, packing, sc, zs, wcol, c,
                              mirror=not last)
        Q, out = out, Q
    STATS.count("gemm_flops", flops)
    return Q


def _relax_round(Q, out, packing: Packing, sc, zs, wcol, cutoff: float,
                 mirror: bool) -> int:
    """One round from Q into `out`.  A panel's strip right of its first
    block holds the panel's blocks i < j and, inside the panel, its zero
    diagonal blocks and some blocks below the diagonal; with `mirror`,
    every row block's upper strip is then written, transposed, below the
    diagonal, over those too.  Returns the products' 2 m n k."""
    offs = packing.offs
    side = packing.side
    zero = Q.new_zeros(())
    flops = 0
    for i0, i1 in _panels(offs):
        r0, r1, c0 = int(offs[i0]), int(offs[i1]), int(offs[i0 + 1])
        a = Q[r0:r1] if wcol is None else Q[r0:r1] * wcol
        prod = a @ Q[:, c0:]
        del a
        flops += 2 * (r1 - r0) * (side - c0) * side
        rows = packing._blk[r0:r1]
        s = Q[r0:r1, c0:]
        # relax_dense_rounds' epilogue, operation for operation
        r = sc[rows, c0:] * s + zs[rows, c0:] * prod
        del prod
        torch.where((s > 0) & (r >= cutoff), r, zero, out=out[r0:r1, c0:])
        if mirror:
            for i in range(i0, i1):
                lo, hi = int(offs[i]), int(offs[i + 1])
                out[hi:, lo:hi].copy_(out[lo:hi, hi:].T)
    return flops
