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

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from mlprobs_tpu_torch.align.aligner import align_family, family_viterbi_stats
from mlprobs_tpu_torch.core import alphabet
from mlprobs_tpu_torch.core.config import DEFAULT as _CFG
from mlprobs_tpu_torch.core.msa import MSA
from mlprobs_tpu_torch.models import forests
from mlprobs_tpu_torch.ops.colscore import column_scores
from mlprobs_tpu_torch.ops.kernels.build import KernelBuildError
from mlprobs_tpu_torch.ops.kernels.wavefront_kernel import KernelArgumentError
from mlprobs_tpu_torch.pipeline import regions as reg
from mlprobs_tpu_torch.pipeline.realign import realign_and_combine
from mlprobs_tpu_torch.utils import device as devlib
from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS

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


@STATS.span("run_pipeline")
def run_pipeline(
    records: list[tuple[str, str]], verbose: bool = False, device="cuda",
) -> tuple[MSA, PipelineReport]:
    """Run the full MLProbs pipeline on one family.  Each stage is the
    span `stage.<name>`; `rep.timings[name]` is its end in seconds from
    the start."""
    device = devlib.resolve(device)
    rep = PipelineReport(num_seqs=len(records))
    log = print if verbose else (lambda *a, **k: None)
    t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(name):
        with STATS.span(f"stage.{name}"):
            yield
        rep.timings[name] = time.perf_counter() - t0

    if len(records) <= 1:
        return MSA.from_records(records), rep

    try:
        # ---- classifier-1 features (the -G pass) -----------------------
        with stage("features"):
            enc = [alphabet.degap(alphabet.encode(s)) for _, s in records]
            stats = family_viterbi_stats(enc, with_features=True,
                                         device=device)
            rep.avg_pid, rep.sd_pid = stats.avg_pid, stats.sd_pid
            rep.factor = stats.factor
        log(f"[MAIN STEP] features: pid={stats.avg_pid:.3f} "
            f"sd={stats.sd_pid:.3f} factor={stats.factor}")

        # ---- classifier 1: strategy ------------------------------------
        with stage("classifier1"):
            strategy = forests.classify_strategy(
                stats.avg_pid, stats.num_seqs, stats.avg_len,
                stats.avg_sp, stats.peak_ratio,
            )
            rep.strategy = strategy
        log(f"[MAIN STEP] strategy: "
            f"{'non-progressive' if strategy else 'progressive'}")

        # ---- base MSA --------------------------------------------------
        with stage("base_msa"):
            base = align_family(
                records, config="pnp", stats=stats, strategy=strategy,
                report=rep.engines, device=device,
            )
            base = base.sort_by_header()

        # ---- column scores + classifier 3 ------------------------------
        with stage("classifier3"):
            col = column_scores(base.rows)
            un_sp = float(col.mean()) if col.size else 0.0
            sd_un_sp = (float(np.sqrt(((col - un_sp) ** 2).mean()))
                        if col.size else 0.0)
            peak = float((col >= 1.0).mean()) if col.size else 0.0
            realign_mode = forests.classify_realign_strategy(
                peak, stats.avg_pid, sd_un_sp, un_sp
            )
            rep.realign_mode = realign_mode
        log(f"[MAIN STEP] {'RIR' if realign_mode else 'RCR'} selected")

        # ---- segmentation ----------------------------------------------
        with stage("segmentation"):
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

        # ---- realign + recombine ---------------------------------------
        with stage("realign"):
            do_blocks = realign_mode == 1 or stats.factor > 0
            if realign_mode == 0 and stats.factor <= 0:
                # RCR with non-positive factor: realign the whole family
                # (do_realign.py ExceptionHandling) — a *legitimate*
                # path, not a crash
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
    except (NotImplementedError, KernelBuildError, KernelArgumentError):
        raise
    except Exception as e:
        if verbose:
            raise
        # stage failure: degrade to whole-family QuickProbs-role
        # alignment, recording what broke and where (SURVEY §5.5)
        failed_at = next(reversed(rep.timings), "start")
        rep.error = f"{type(e).__name__}@{failed_at}: {e}"
        STATS.count("pipeline.crash_fallback")
        with stage("fallback"):
            out = _fallback_align(records, rep, _is_oom(e), device)
            rep.crash_fallback = True
            rep.fallback = True

    with stage("total"):
        if out.num_seqs == 0 or out.length == 0:
            out = _fallback_align(records, rep, False, device)
            rep.crash_fallback = True
            rep.fallback = True
            rep.error = rep.error or "EmptyOutput@realign: empty final MSA"
        rep.final_hash = out.content_hash()
    return out, rep
