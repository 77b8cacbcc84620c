"""Column reliability scoring (sum-of-pairs BLOSUM62 per column).

Reference: utils/calculate_column_scores.py — a Python O(L * N^2) loop in
the original; here a single einsum over per-column residue counts:

    2 * sum_{k1<k2} B[a_k1, a_k2]  =  c^T B c - sum_i B[a_i, a_i]

with c the 20-class count vector of the column.  Gaps and non-standard
residues contribute zero (reference getIdx returns -1 for both).  Host
numpy in f64, as the pipeline scores its MSAs; `column_scores_torch` is
the f32 version for a tensor on any device (the JAX package's
`column_scores_jnp`).
"""
from __future__ import annotations

import numpy as np
import torch

from mlprobs_tpu_torch.models.params import blosum62


def column_scores(rows: np.ndarray) -> np.ndarray:
    """Per-column mean pairwise BLOSUM score.

    rows: (N, L) int8 with -1 for gaps, 20 for unknown residues.
    Returns (L,) float64; divisor is N*(N-1)/2 over all rows (gaps
    included in the pair count), matching the reference.
    """
    n, length = rows.shape
    if n < 2 or length == 0:
        return np.zeros(length)
    b = np.asarray(blosum62(), dtype=np.float64)  # (21,21); unknown row = 0
    valid = (rows >= 0) & (rows < 20)
    cls = np.where(valid, rows, 20).astype(np.int64)
    counts = np.zeros((length, 21))
    np.add.at(counts, (np.arange(length)[None, :].repeat(n, 0), cls),
              np.ones((n, length)))
    counts[:, 20] = 0.0
    total = np.einsum("lc,cd,ld->l", counts, b, counts)
    self_terms = np.where(valid, np.diag(b)[cls], 0.0).sum(axis=0)
    pairs = n * (n - 1) / 2.0
    return (total - self_terms) / 2.0 / pairs


def column_scores_torch(rows: torch.Tensor) -> torch.Tensor:
    """`column_scores` in f32 on the device of `rows` ((N, L) integer
    tensor, -1 for gaps); (L,) scores."""
    n = rows.shape[0]
    b20 = torch.as_tensor(blosum62()[:20, :20], device=rows.device)
    valid = (rows >= 0) & (rows < 20)
    cls = torch.where(valid, rows, 20)
    onehot = (torch.arange(20, device=rows.device)[None, None, :]
              == cls[:, :, None]).to(torch.float32)       # (N, L, 20)
    counts = onehot.sum(dim=0)                            # (L, 20)
    total = torch.einsum("lc,cd,ld->l", counts, b20, counts)
    self_terms = (counts * torch.diag(b20)[None, :]).sum(dim=1)
    pairs = n * (n - 1) / 2.0
    return (total - self_terms) / 2.0 / pairs


def score_stats(col_score: np.ndarray) -> tuple[float, float, float]:
    """(mean, sd, peak_length_ratio) of a column-score vector.

    peak_length_ratio = fraction of columns with score >= 1.0
    (calculate_column_scores.py:130-135).
    """
    if col_score.size == 0:
        return 0.0, 0.0, 0.0
    mean = float(col_score.mean())
    sd = float(np.sqrt(((col_score - mean) ** 2).mean()))
    peak = float((col_score >= 1.0).mean())
    return mean, sd, peak
