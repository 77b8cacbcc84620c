"""Selective block realignment, acceptance testing, and recombination.

Reference: utils/do_realign.py.  Each realign block is degapped (all-gap
rows set aside), realigned with the QuickProbs-role aligner on the
caller's device, accepted only if it does not lower the average column
score, then re-joined with the kept blocks column-wise by (sorted)
header.
"""
from __future__ import annotations

import numpy as np
import torch

from mlprobs_tpu_torch.align.aligner import align_family
from mlprobs_tpu_torch.core import alphabet
from mlprobs_tpu_torch.core.msa import MSA
from mlprobs_tpu_torch.ops.colscore import column_scores
from mlprobs_tpu_torch.pipeline.regions import Block
from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS

# What the reference keeps a block for when its realigner fails on it
# (do_realign.py): the block's own input or the memory it needs.  A
# missing kernel, a kernel given an argument it does not take
# (KernelArgumentError) or a failed CUDA launch is a fault of the
# program, not of the block, and propagates.
BLOCK_RECOVERABLE = (torch.cuda.OutOfMemoryError, MemoryError,
                     ArithmeticError, ValueError, IndexError)


def avg_col_score(rows: np.ndarray) -> float:
    """Mean column score of an alignment block (getAvgColScore)."""
    n, length = rows.shape
    if n < 2 or length == 0:
        return -1.0
    return float(column_scores(rows).mean())


def realign_block(block_msa: MSA, device="cuda", report=None) -> MSA:
    """Realign one column block; returns the accepted block MSA.

    The block arrives with rows sorted by header.  All-gap rows are
    dropped before realignment and re-appended (as full-gap rows of the
    new width) afterwards, preserving header-sorted order at the end.
    `report` (a PipelineReport) counts the blocks realigned and accepted
    and records every failure the block is kept for.  A block that goes
    through the realigner is the span `realign.block`, with the counters
    `blocks`, `blocks_accepted` and `block_columns` (its width in the
    base MSA).
    """
    keep_rows = []
    gap_headers = []
    for i in range(block_msa.num_seqs):
        if (block_msa.rows[i] >= 0).any():
            keep_rows.append(i)
        else:
            gap_headers.append(block_msa.headers[i])
    if len(keep_rows) == 0:
        return block_msa
    sub = block_msa.project(keep_rows)
    records = [
        (sub.headers[i], alphabet.decode(sub.rows[i]).replace("-", ""))
        for i in range(sub.num_seqs)
    ]
    if len(records) == 1:
        new = MSA.from_records(records)
    else:
        with STATS.span("realign.block"):
            STATS.count("blocks")
            STATS.count("block_columns", block_msa.length)
            if report is not None:
                report.blocks_realigned += 1
            try:
                new = align_family(records, config="quickprobs",
                                   device=device)
            except BLOCK_RECOVERABLE as e:
                STATS.count("pipeline.block_errors")
                if report is not None:
                    report.block_errors.append(
                        f"{type(e).__name__}: {e}"[:240])
                return block_msa
            new = new.sort_by_header()
            # acceptance: keep realignment only if avg column score does
            # not drop (do_realign.py:64-70)
            if avg_col_score(block_msa.rows) > avg_col_score(new.rows):
                return block_msa
            STATS.count("blocks_accepted")
            if report is not None:
                report.blocks_accepted += 1
    # re-append all-gap rows padded to the new width, header-sorted
    width = new.length
    headers = list(new.headers) + gap_headers
    rows = np.concatenate(
        [new.rows, np.full((len(gap_headers), width), -1, np.int8)], axis=0
    )
    merged = MSA(headers=headers, rows=rows,
                 labels=np.arange(len(headers), dtype=np.int32))
    return merged.sort_by_header()


def realign_and_combine(
    base: MSA, blocks: list[Block], do_realign: bool, device="cuda",
    report=None,
) -> MSA:
    """Process all blocks and stitch them back column-wise by header.

    `base` must be header-sorted.  If `do_realign` is False the realign
    blocks are kept as-is (factor <= 0 RCR case falls back upstream).
    The stitching is the span `realign.combine`.
    """
    n = base.num_seqs
    headers = list(base.headers)
    parts: list[np.ndarray] = []
    for blk in blocks:
        piece = MSA(
            headers=headers,
            rows=base.rows[:, blk.start : blk.end + 1],
            labels=base.labels.copy(),
        )
        if blk.realign and do_realign:
            piece = realign_block(piece, device=device, report=report)
            # recombination guard: wrong sequence count -> keep original
            if piece.num_seqs != n or piece.headers != headers:
                piece = MSA(
                    headers=headers,
                    rows=base.rows[:, blk.start : blk.end + 1],
                    labels=base.labels.copy(),
                )
        parts.append(piece.rows)
    with STATS.span("realign.combine"):
        rows = np.concatenate(parts, axis=1) if parts else base.rows
        return MSA(headers=headers, rows=rows, labels=base.labels.copy())
