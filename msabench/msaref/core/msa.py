# Frozen copy of mlprobs_tpu_torch/core/msa.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Gapped multiple-sequence-alignment container.

Replaces the reference's MultiSequence/Sequence classes
(baseMSA MultiSequence.h, Sequence.h) with a flat numpy representation:
rows are int8-encoded residues with -1 for gaps.  Provides the operations
the pipeline needs: projection onto a subset, ungapped->column mappings
(Sequence::GetMapping), merging two alignments along an edit path
(Sequence::AddGaps), and label-order sorting (SortByLabel).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from msabench.msaref.core import alphabet
from msabench.msaref.core.fasta import parse_fasta


@dataclass
class MSA:
    headers: list[str]           # FASTA headers (no '>')
    rows: np.ndarray             # (N, L) int8; -1 = gap
    labels: np.ndarray           # (N,) int32 original input-order labels

    # ---------------------------------------------------------------- basics
    @property
    def num_seqs(self) -> int:
        return self.rows.shape[0]

    @property
    def length(self) -> int:
        return self.rows.shape[1]

    @classmethod
    def from_records(cls, records: list[tuple[str, str]]) -> "MSA":
        if not records:
            return cls(headers=[], rows=np.zeros((0, 0), np.int8),
                       labels=np.zeros(0, np.int32))
        lens = {len(s) for _, s in records}
        if len(lens) != 1:
            raise ValueError(f"ragged alignment rows: lengths {sorted(lens)}")
        rows = np.stack([alphabet.encode(s) for _, s in records])
        return cls(
            headers=[h for h, _ in records],
            rows=rows.astype(np.int8),
            labels=np.arange(len(records), dtype=np.int32),
        )

    @classmethod
    def from_unaligned(cls, records: list[tuple[str, str]]) -> "MSA":
        """Build from unaligned sequences, right-padding rows with gaps.

        project([i]) recovers each ungapped sequence, so the container
        doubles as the leaf store for progressive alignment.
        """
        if not records:
            return cls.from_records(records)
        enc = [alphabet.encode(s) for _, s in records]
        width = max(len(e) for e in enc)
        rows = np.full((len(enc), width), -1, dtype=np.int8)
        for i, e in enumerate(enc):
            rows[i, : len(e)] = e
        return cls(
            headers=[h for h, _ in records],
            rows=rows,
            labels=np.arange(len(records), dtype=np.int32),
        )

    @classmethod
    def from_text(cls, text: str) -> "MSA":
        return cls.from_records(parse_fasta(text))

    def to_records(self) -> list[tuple[str, str]]:
        return [
            (h, alphabet.decode(self.rows[i]))
            for i, h in enumerate(self.headers)
        ]

    def content_hash(self) -> str:
        """sha256 over the FASTA rendering — a quick equality check on
        final alignments (MultiSequence::calculateHash,
        MultiSequence.cpp:466-474 / ExtendedMSA.cpp:221)."""
        import hashlib

        h = hashlib.sha256()
        for hdr, seq in self.to_records():
            h.update(hdr.encode())
            h.update(b"\n")
            h.update(seq.encode())
            h.update(b"\n")
        return h.hexdigest()[:16]

    # ------------------------------------------------------------ operations
    def ungapped(self) -> list[np.ndarray]:
        """Per-row encoded sequences with gaps removed."""
        return [alphabet.degap(self.rows[i]) for i in range(self.num_seqs)]

    def mapping(self, i: int) -> np.ndarray:
        """Ungapped position (1-based) -> alignment column (1-based).

        Entry 0 is 0, mirroring Sequence::GetMapping (Sequence.h:412+).
        """
        cols = np.flatnonzero(self.rows[i] >= 0) + 1
        return np.concatenate([[0], cols]).astype(np.int32)

    def project(self, idx: list[int] | np.ndarray) -> "MSA":
        """Project onto a subset of rows, dropping all-gap columns.

        cf. MultiSequence::Project (MultiSequence.h:671).
        """
        idx = np.asarray(idx, dtype=np.int64)
        sub = self.rows[idx]
        keep = (sub >= 0).any(axis=0)
        return MSA(
            headers=[self.headers[i] for i in idx],
            rows=sub[:, keep],
            labels=self.labels[idx],
        )

    def sort_by_label(self) -> "MSA":
        order = np.argsort(self.labels, kind="stable")
        return MSA(
            headers=[self.headers[i] for i in order],
            rows=self.rows[order],
            labels=self.labels[order],
        )

    def sort_by_header(self) -> "MSA":
        order = sorted(range(self.num_seqs), key=lambda i: self.headers[i])
        return MSA(
            headers=[self.headers[i] for i in order],
            rows=self.rows[order],
            labels=self.labels[order],
        )


def merge_alignments(left: MSA, right: MSA, path: np.ndarray) -> MSA:
    """Merge two alignments along an edit path.

    `path` is an int8 vector over merged columns: 0 = column from both
    ('B'), 1 = column only from left ('X'), 2 = only from right ('Y').
    Mirrors Sequence::AddGaps + the AlignAlignments recombination
    (MSA.cpp:1456-1463).
    """
    m = path.shape[0]
    out = np.full((left.num_seqs + right.num_seqs, m), -1, dtype=np.int8)
    lcols = np.flatnonzero(path != 2)
    rcols = np.flatnonzero(path != 1)
    out[: left.num_seqs, lcols] = left.rows
    out[left.num_seqs :, rcols] = right.rows
    return MSA(
        headers=left.headers + right.headers,
        rows=out,
        labels=np.concatenate([left.labels, right.labels]),
    )
