# Frozen copy of mlprobs_tpu_torch/pipeline/driver.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""The MLProbs pipeline driver.

The MLProbs.py role: feature extraction -> classifier 1 (P/NP strategy)
-> base MSA -> column scores -> classifier 3 (RCR/RIR) -> [classifier 2
(min region length)] -> region segmentation -> selective block
realignment with acceptance -> recombination, with the reference's
stage-fallback semantics (a stage failure degrades to a whole-family
QuickProbs-role alignment, cf. MLProbs.py:84-99).  Everything runs on
one device: the card unless the caller asks for the CPU.  A fault of the
program is not answered by the fallback: NotImplementedError, a kernel
that cannot be built (KernelBuildError) and a kernel given an argument
it does not take (KernelArgumentError) leave run_pipeline.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from msabench.msaref.align.aligner import align_family, family_viterbi_stats
from msabench.msaref.core import alphabet
from msabench.msaref.core.config import DEFAULT as _CFG
from msabench.msaref.core.msa import MSA
from msabench.msaref.models import forests
from msabench.msaref.ops.colscore import column_scores
from msabench.msaref.ops.plain import KernelArgumentError, KernelBuildError
from msabench.msaref.pipeline import regions as reg
from msabench.msaref.pipeline.realign import realign_and_combine
from msabench.msaref.utils import device as devlib
from msabench.msaref.utils.stats import GLOBAL as STATS

SIGMA = _CFG.pipeline.sigma          # MLProbs.py:24
BETA = _CFG.pipeline.beta            # MLProbs.py:25
THRESHOLD = _CFG.pipeline.threshold  # MLProbs.py:26


@dataclass
class PipelineReport:
    """Stage decisions and timings for observability.

    `crash_fallback` (a stage raised; see `error` for the cause) is kept
    distinct from `whole_family_realign` (the *legitimate* RCR
    factor<=0 whole-family realign, do_realign.py ExceptionHandling).
    `fallback` is the union.  `block_errors` lists each block failure
    the realign stage kept the block for ("<Type>: <message>");
    `device_suspect` says the fallback followed a device OOM."""

    num_seqs: int = 0
    avg_pid: float = 0.0
    sd_pid: float = 0.0
    factor: float = 0.0
    strategy: int = 0          # classifier 1: 0=P, 1=NP
    realign_mode: int = 1      # classifier 3: 0=RCR, 1=RIR
    min_length_class: int = 3  # classifier 2
    num_realign_blocks: int = 0
    blocks_realigned: int = 0  # blocks that went through the realigner
    blocks_accepted: int = 0   # ... and passed the acceptance test
    block_errors: list = field(default_factory=list)
    fallback: bool = False
    crash_fallback: bool = False
    whole_family_realign: bool = False
    device_suspect: bool = False
    error: str = ""            # "<Type>@<stage>: <message>" on crash
    engines: dict = field(default_factory=dict)  # posterior/consistency
    final_hash: str = ""       # MSA.content_hash of the final MSA
    timings: dict = field(default_factory=dict)


def _is_oom(e: BaseException) -> bool:
    return (isinstance(e, (torch.cuda.OutOfMemoryError, MemoryError))
            or "out of memory" in str(e).lower())


def _fallback_align(records, rep: PipelineReport, device_suspect: bool,
                    device: torch.device) -> MSA:
    """Whole-family QuickProbs-role alignment on the same device.

    The reference's ladder re-runs a binary that still works
    (MLProbs.py:84-99).  After a device OOM the card's cached blocks are
    released and the report marks the device suspect before the retry;
    a failure here propagates."""
    if device_suspect:
        rep.device_suspect = True
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return align_family(records, config="quickprobs", report=rep.engines,
                        device=device).sort_by_header()


def run_pipeline(
    records: list[tuple[str, str]], verbose: bool = False, device="cuda",
) -> tuple[MSA, PipelineReport]:
    """Run the full MLProbs pipeline on one family."""
    device = devlib.resolve(device)
    rep = PipelineReport(num_seqs=len(records))
    log = print if verbose else (lambda *a, **k: None)
    t0 = time.time()
    last = [t0]

    def mark(name):
        now = time.time()
        rep.timings[name] = now - t0
        STATS.add(f"stage.{name}", now - last[0])
        last[0] = now

    if len(records) <= 1:
        return MSA.from_records(records), rep

    try:
        # ---- classifier-1 features (the -G pass) -----------------------
        enc = [alphabet.degap(alphabet.encode(s)) for _, s in records]
        stats = family_viterbi_stats(enc, with_features=True, device=device)
        rep.avg_pid, rep.sd_pid = stats.avg_pid, stats.sd_pid
        rep.factor = stats.factor
        mark("features")
        log(f"[MAIN STEP] features: pid={stats.avg_pid:.3f} "
            f"sd={stats.sd_pid:.3f} factor={stats.factor}")

        # ---- classifier 1: strategy ------------------------------------
        strategy = forests.classify_strategy(
            stats.avg_pid, stats.num_seqs, stats.avg_len,
            stats.avg_sp, stats.peak_ratio,
        )
        rep.strategy = strategy
        mark("classifier1")
        log(f"[MAIN STEP] strategy: "
            f"{'non-progressive' if strategy else 'progressive'}")

        # ---- base MSA --------------------------------------------------
        base = align_family(
            records, config="pnp", stats=stats, strategy=strategy,
            report=rep.engines, device=device,
        )
        base = base.sort_by_header()
        mark("base_msa")

        # ---- column scores + classifier 3 ------------------------------
        col = column_scores(base.rows)
        un_sp = float(col.mean()) if col.size else 0.0
        sd_un_sp = (
            float(np.sqrt(((col - un_sp) ** 2).mean())) if col.size else 0.0
        )
        peak = float((col >= 1.0).mean()) if col.size else 0.0
        realign_mode = forests.classify_realign_strategy(
            peak, stats.avg_pid, sd_un_sp, un_sp
        )
        rep.realign_mode = realign_mode
        mark("classifier3")
        log(f"[MAIN STEP] {'RIR' if realign_mode else 'RCR'} selected")

        # ---- segmentation ----------------------------------------------
        if realign_mode == 1:
            class_lens = forests.classify_region_min_length(
                base.length, base.num_seqs, stats.avg_pid,
                stats.sd_pid, un_sp,
            )
            rep.min_length_class = int(class_lens)
            found = reg.find_unreliable_regions(
                list(col), SIGMA, BETA, class_lens
            )
        else:
            found = reg.find_reliable_regions(list(col), THRESHOLD, 0)
        blocks = reg.partition_columns(found, base.length)
        rep.num_realign_blocks = sum(b.realign for b in blocks)
        mark("segmentation")

        # ---- realign + recombine ---------------------------------------
        do_blocks = realign_mode == 1 or stats.factor > 0
        if realign_mode == 0 and stats.factor <= 0:
            # RCR with non-positive factor: realign the whole family
            # (do_realign.py ExceptionHandling) — a *legitimate* path,
            # not a crash
            out = align_family(
                records, config="quickprobs", report=rep.engines,
                device=device,
            )
            out = out.sort_by_header()
            rep.whole_family_realign = True
            rep.fallback = True
        else:
            out = realign_and_combine(base, blocks, do_blocks,
                                      device=device, report=rep)
        mark("realign")
    except (NotImplementedError, KernelBuildError, KernelArgumentError):
        raise
    except Exception as e:
        if verbose:
            raise
        # stage failure: degrade to whole-family QuickProbs-role
        # alignment, recording what broke and where (SURVEY §5.5)
        stage = next(reversed(rep.timings), "start") if rep.timings \
            else "start"
        rep.error = f"{type(e).__name__}@{stage}: {e}"
        STATS.add("pipeline.crash_fallback", 1.0)
        out = _fallback_align(records, rep, _is_oom(e), device)
        rep.crash_fallback = True
        rep.fallback = True
        mark("fallback")

    if out.num_seqs == 0 or out.length == 0:
        out = _fallback_align(records, rep, False, device)
        rep.crash_fallback = True
        rep.fallback = True
        rep.error = rep.error or "EmptyOutput@realign: empty final MSA"
    rep.final_hash = out.content_hash()
    mark("total")
    return out, rep
