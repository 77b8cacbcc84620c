# Frozen copy of mlprobs_tpu_torch/pipeline/regions.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Column-score region segmentation (RIR / RCR).

Reference: utils/unreliable_regions.py, utils/reliable_regions.py.
Both are run-length state machines over the per-column reliability
scores; regions are emitted as [head, tail] pairs of 1-based column
indices with the reference's exact boundary quirks (a run must have
length >= 3 columns to register; the closing of a run at the final
column uses `item == last_col`).

Region kinds:
  RIR (class 1): runs with beta <= score <= sigma longer than the
    classifier-2 min length {0:1, 1:10, 2:20, 3:30} are *unreliable*.
  RCR (class 0): runs with score > threshold(2.0) longer than
    max(min_len, 3) are the blocks to realign (written with the
    "unreliable" role — the extension marks "to be realigned").
"""
from __future__ import annotations

from dataclasses import dataclass

MIN_LEN_BY_CLASS = {0: 1, 1: 10, 2: 20, 3: 30}


@dataclass
class Block:
    start: int      # 0-based inclusive column
    end: int        # 0-based inclusive column
    realign: bool   # True = this block goes through the realigner


def find_unreliable_regions(
    col_score: list[float], sigma: float, beta: float, class_lens: int
) -> list[tuple[int, int]]:
    """RIR region finder (unreliable_regions.py:9-44); 1-based bounds."""
    min_len = MIN_LEN_BY_CLASS.get(int(class_lens), 30)
    last = len(col_score) - 1
    regions = []
    t1 = t2 = 0
    head = 0
    for idx, score in enumerate(col_score):
        inside = beta <= score <= sigma
        if inside and t1 == 0:
            head = idx + 1
            t1 = 1
        elif inside and t1 == 1 and t2 == 0:
            t2 = 1
        elif inside and t1 == 1 and t2 == 1:
            if idx == last:
                if idx - head > min_len:
                    regions.append((head, idx))
        elif (not inside) and t1 == 1 and t2 == 1:
            if idx - head > min_len:
                regions.append((head, idx))
            t1 = t2 = head = 0
        else:
            t1 = t2 = head = 0
    return regions


def find_reliable_regions(
    col_score: list[float], threshold: float, min_len: int = 0
) -> list[tuple[int, int]]:
    """RCR region finder (reliable_regions.py:10-53); 1-based bounds."""
    last = len(col_score) - 1
    regions = []
    t1 = t2 = 0
    head = 0
    for idx, score in enumerate(col_score):
        inside = score > threshold
        if inside and t1 == 0:
            head = idx + 1
            t1 = 1
        elif inside and t1 == 1 and t2 == 0:
            t2 = 1
        elif inside and t1 == 1 and t2 == 1:
            if idx == last:
                if idx - head > min_len and idx - head >= 3:
                    regions.append((head, idx))
        elif (not inside) and t1 == 1 and t2 == 1:
            if idx - head > min_len and idx - head >= 3:
                regions.append((head, idx))
            t1 = t2 = head = 0
        else:
            t1 = t2 = head = 0
    return regions


def partition_columns(
    regions: list[tuple[int, int]], total_cols: int
) -> list[Block]:
    """Slice the MSA columns into realign/keep blocks.

    Mirrors seperateUnreliableRegions / seperateReliableRegions: regions
    come as 1-based [head, tail]; the written realign block spans
    columns head-1 .. tail-1 (0-based), keep blocks fill the gaps.
    """
    if not regions:
        return [Block(0, total_cols - 1, realign=False)]
    blocks: list[Block] = []
    first_head = regions[0][0]
    if first_head > 1:
        blocks.append(Block(0, first_head - 2, realign=False))
    for k, (head, tail) in enumerate(regions):
        blocks.append(Block(head - 1, tail - 1, realign=True))
        if k + 1 < len(regions):
            nxt = regions[k + 1][0]
            blocks.append(Block(tail, nxt - 2, realign=False))
    last_tail = regions[-1][1]
    if last_tail < total_cols:
        blocks.append(Block(last_tail, total_cols - 1, realign=False))
    return blocks
