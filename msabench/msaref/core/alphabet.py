# Frozen copy of mlprobs_tpu_torch/core/alphabet.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Residue alphabet and integer encoding.

The engine works on int8-encoded sequences: indices 0..19 are the standard
amino acids in ProbCons order, index 20 is the catch-all "unknown" class
(X/B/Z/J/O/U and anything else).  Emission/substitution tables are built
with 21 rows/cols so unknown residues hit the reference's default
probabilities (cf. reference MSA.cpp:46-47: emitPairs default 1e-10,
emitSingle default 1e-5 for characters outside the alphabet).
"""
from __future__ import annotations

import numpy as np

# ProbCons amino-acid order (reference Defaults.h:29).
AMINO_ORDER = "ARNDCQEGHILKMFPSTWYV"
UNKNOWN = 20          # catch-all class for non-standard residues
NUM_CLASSES = 21      # 20 standard + unknown
GAP_CHARS = "-."

# char byte -> class index; unknown residues map to UNKNOWN, gaps to -1.
_LUT = np.full(256, UNKNOWN, dtype=np.int8)
for _i, _c in enumerate(AMINO_ORDER):
    _LUT[ord(_c)] = _i
    _LUT[ord(_c.lower())] = _i
for _c in GAP_CHARS:
    _LUT[ord(_c)] = -1

_DECODE = np.frombuffer((AMINO_ORDER + "X").encode(), dtype=np.uint8)


def encode(seq: str) -> np.ndarray:
    """Encode a residue string to int8 classes; gap chars become -1."""
    raw = np.frombuffer(seq.encode(), dtype=np.uint8)
    return _LUT[raw]


def decode(ids: np.ndarray) -> str:
    """Decode int8 classes back to characters (UNKNOWN -> 'X', -1 -> '-')."""
    ids = np.asarray(ids)
    out = np.where(ids < 0, ord("-"), _DECODE[np.clip(ids, 0, UNKNOWN)])
    return out.astype(np.uint8).tobytes().decode()


def degap(ids: np.ndarray) -> np.ndarray:
    """Remove gap entries (-1) from an encoded sequence."""
    return ids[ids >= 0]
