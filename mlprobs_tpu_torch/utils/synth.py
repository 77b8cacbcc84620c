"""Seeded synthetic protein families (test and smoke inputs).

A family descends from one random ancestor by independent substitutions,
single-residue deletions and insertions per site; each member is then
cut or padded to a length drawn from [lmin, lmax].  High substitution
rates give twilight-zone families (BAliBASE RV11/12-like identity).
"""
from __future__ import annotations

import numpy as np

from mlprobs_tpu_torch.core.alphabet import AMINO_ORDER

_LETTERS = np.frombuffer(AMINO_ORDER.encode(), dtype=np.uint8)


def synthetic_family(n: int, lmin: int, lmax: int, sub: float,
                     indel: float, seed: int) -> list[tuple[str, str]]:
    """`n` (header, sequence) records of lengths in [lmin, lmax]."""
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, 20, lmax)
    recs = []
    for k in range(n):
        keep = rng.random(lmax) >= indel / 2
        s = np.where(rng.random(lmax) < sub, rng.integers(0, 20, lmax), anc)
        ins = rng.random(lmax) < indel / 2
        parts = [s[keep], rng.integers(0, 20, int(ins.sum()))]
        pos = np.concatenate([np.flatnonzero(keep),
                              np.flatnonzero(ins) + 0.5])
        seq = np.concatenate(parts)[np.argsort(pos, kind="stable")]
        length = int(rng.integers(lmin, lmax + 1))
        if len(seq) >= length:
            start = int(rng.integers(0, len(seq) - length + 1))
            seq = seq[start:start + length]
        else:
            seq = np.concatenate(
                [seq, rng.integers(0, 20, length - len(seq))])
        recs.append((f"seq{k:03d}", _LETTERS[seq].tobytes().decode()))
    return recs
