"""Seeded synthetic protein families, the one generator of every traffic.

`synthetic_family` is a frozen copy of mlprobs_tpu_torch/utils/synth.py
at commit 30598a0, with one addition: `lengths`, when given, replaces
the lengths the member draws (the draw is still made, so the residues
are those of the copy without it).  `family` builds family k of a run
from a configuration's `family` block and the run's seed.
"""
from __future__ import annotations

import numpy as np

# mlprobs_tpu_torch/core/alphabet.py AMINO_ORDER at commit 30598a0
AMINO_ORDER = "ARNDCQEGHILKMFPSTWYV"
_LETTERS = np.frombuffer(AMINO_ORDER.encode(), dtype=np.uint8)

# SeedSequence keys: the window's families, the warm-up family, the
# sample that the correctness check draws
WINDOW, WARMUP, SAMPLE = 0, 1, 2


def synthetic_family(n: int, lmin: int, lmax: int, sub: float,
                     indel: float, seed, lengths=None
                     ) -> list[tuple[str, str]]:
    """`n` (header, sequence) records of lengths in [lmin, lmax]: each
    member descends from one random ancestor by substitutions and
    single-residue deletions and insertions per site, then is cut or
    padded to its length."""
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
        if lengths is not None:
            length = int(lengths[k])
        if len(seq) >= length:
            start = int(rng.integers(0, len(seq) - length + 1))
            seq = seq[start:start + length]
        else:
            seq = np.concatenate(
                [seq, rng.integers(0, 20, length - len(seq))])
        recs.append((f"seq{k:03d}", _LETTERS[seq].tobytes().decode()))
    return recs


def seed_sequence(seed: int, *key: int) -> np.random.SeedSequence:
    """The stream of (seed, key...); any whole seed, negative ones too."""
    return np.random.SeedSequence([int(seed) % (1 << 64), *key])


def family(spec: dict, seed: int, k: int, key: int = WINDOW
           ) -> list[tuple[str, str]]:
    """Family k of a run with `seed`, from a configuration's `family`
    block: n, lmin, lmax, sub, indel, and `cuts`, per member null or
    [start, stop], a slice of the member's residues.  The n lengths are
    spread evenly over [lmin, lmax], in an order drawn from the seed, so
    that every family of every seed does the same work."""
    fam_ss, order_ss = seed_sequence(seed, key, k).spawn(2)
    n, lmin, lmax = spec["n"], spec["lmin"], spec["lmax"]
    even = [lmin + (lmax - lmin) * (2 * i + 1) // (2 * n) for i in range(n)]
    lengths = np.random.default_rng(order_ss).permutation(even)
    recs = synthetic_family(n, lmin, lmax, spec["sub"], spec["indel"],
                            fam_ss, lengths=lengths)
    cuts = spec.get("cuts") or [None] * n
    return [(h, s if cut is None else s[cut[0]:cut[1]])
            for (h, s), cut in zip(recs, cuts)]
