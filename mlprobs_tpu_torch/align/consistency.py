"""Probabilistic-consistency transform.

Reference: MSA::DoRelaxation (MSA.cpp:1172-1281):

    P'(x,y) = (2 P(x,y) + sum_{z != x,y} P(x,z) P(z,y)) / N

masked to the original sparsity support and re-thresholded at 0.01.

* `relax_dense_rounds` (device): the contraction over a dense zero-diagonal
  (N, N, Lp, Lp) posterior tensor, one f32 einsum per round (a plain large
  product, left to the library as the JAX package left it to XLA).
* `relax_sparse` (host): one product of the (sum(L) x sum(L)) block matrix
  Q with identity diagonal blocks — Q^2 block (i,j) is exactly
  2 P_ij + sum_z P_iz P_zj.  scipy CSR; the path of families with fewer
  than three sequences and of the recorded device downgrades.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

CUTOFF = 0.01  # SparseMatrix.h:14


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
