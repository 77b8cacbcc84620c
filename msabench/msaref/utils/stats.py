# Frozen copy of mlprobs_tpu_torch/utils/stats.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Timing and statistics registry.

Equivalent of the reference's observability stack: the [ELAPSED TIME]
print protocol (MLProbs.py), TIMER_* macros + StatisticsProvider
(QuickProbs Common/Timer.h, StatisticsProvider.h) and baseMSA's phase
timers (MSA.cpp:111-121).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Stats:
    """Process-wide key/value stats with accumulating timers."""

    def __init__(self):
        self.values: dict[str, float] = {}
        self.timers: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def write(self, key: str, value) -> None:
        self.values[key] = value

    def add(self, key: str, value: float) -> None:
        self.timers[key] += value
        self.counts[key] += 1

    @contextlib.contextmanager
    def timer(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(key, time.perf_counter() - t0)

    def to_dict(self) -> dict:
        out = dict(self.values)
        for k, v in self.timers.items():
            out[f"time.{k}"] = v
            out[f"calls.{k}"] = self.counts[k]
        return out

    def log_device_memory(self, tag: str) -> None:
        """Record the card's live and peak allocated bytes under `tag`
        (the LOG_MEM analogue, QuickPosteriorStage.cpp:89-101).  No-op
        without CUDA."""
        import torch

        if not torch.cuda.is_available():
            return
        ms = torch.cuda.memory_stats()
        for k in ("allocated_bytes.all.current", "allocated_bytes.all.peak"):
            if k in ms:
                self.write(f"mem.{tag}.{k}", int(ms[k]))

    def reset(self) -> None:
        self.values.clear()
        self.timers.clear()
        self.counts.clear()


GLOBAL = Stats()
