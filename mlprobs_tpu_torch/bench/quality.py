"""Alignment quality scoring: SP / TC against a reference alignment.

The bali_score metrics (SURVEY §4): SP = fraction of aligned residue
pairs of the reference recovered by the test alignment; TC = fraction of
reference columns reproduced exactly.  `cli bench` scores a suite's
alignments with them against its golden directory.  The port's copy of
the JAX package's `bench/quality.py`, with the same arithmetic.
"""
from __future__ import annotations

import numpy as np

from mlprobs_tpu_torch.core.msa import MSA


def _residue_columns(msa: MSA) -> dict[str, np.ndarray]:
    """header -> per-row array mapping ungapped residue index -> column."""
    out = {}
    for i, h in enumerate(msa.headers):
        out[h] = np.flatnonzero(msa.rows[i] >= 0)
    return out


def sp_tc(test: MSA, ref: MSA) -> tuple[float, float]:
    """(SP, TC) of `test` scored against `ref` (same sequences)."""
    tcols = _residue_columns(test)
    rcols = _residue_columns(ref)
    headers = [h for h in ref.headers if h in tcols]
    n = len(headers)
    if n < 2:
        return 1.0, 1.0

    # residue -> column lookup per sequence, both alignments
    # reference pair set per column
    total_pairs = 0
    hit_pairs = 0
    # per column of ref: which (seq, residue-index) present
    ref_col_members: dict[int, list[tuple[int, int]]] = {}
    for si, h in enumerate(headers):
        cols = rcols[h]
        for residx, col in enumerate(cols):
            ref_col_members.setdefault(int(col), []).append((si, residx))

    # test column of each residue
    tpos = [tcols[h] for h in headers]

    tc_hits = 0
    tc_total = 0
    for col, members in ref_col_members.items():
        if len(members) < 2:
            continue
        tc_total += 1
        test_cols = {tpos[si][residx] for si, residx in members}
        if len(test_cols) == 1:
            tc_hits += 1
        for a in range(len(members)):
            for b in range(a + 1, len(members)):
                sa, ra = members[a]
                sb, rb = members[b]
                total_pairs += 1
                if tpos[sa][ra] == tpos[sb][rb]:
                    hit_pairs += 1
    sp = hit_pairs / total_pairs if total_pairs else 1.0
    tc = tc_hits / tc_total if tc_total else 1.0
    return sp, tc


def column_identity(test: MSA, ref: MSA) -> float:
    """Fraction of ref columns exactly present in test (order-free)."""
    ref_s = ref.sort_by_header()
    test_s = test.sort_by_header()
    if ref_s.headers != test_s.headers:
        return 0.0
    tset = {tuple(c) for c in test_s.rows.T.tolist()}
    hits = sum(1 for c in ref_s.rows.T.tolist() if tuple(c) in tset)
    return hits / max(1, ref_s.length)
