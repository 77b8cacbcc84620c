"""Typed configuration unifying the reference's three config tiers.

Reference: MLProbs.py constants (:23-34), baseMSA's argv globals
(MSA.cpp:25-102) and QuickProbs' structured Configuration
(Configuration.h:18-127).  Defaults reproduce the shipped behaviour.

The engine tier is the port's own: its memory budgets come from the
device the run uses (`engine_budgets`), not from a fixed figure.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field


@dataclass
class PipelineConfig:
    """MLProbs.py tier."""

    sigma: float = 1.2         # RIR upper column-score bound
    beta: float = 0.0          # RIR lower bound
    threshold: float = 2.0     # RCR lower bound
    realign: bool = True       # run the region-realign stage


@dataclass
class AlignerConfig:
    """baseMSA tier (c_p_np_aln flags / globals)."""

    consistency_reps: int = 2          # MSA.cpp:34
    refinement_reps: int = 100         # MSA.cpp:36
    posterior_cutoff: float = 0.01     # SparseMatrix.h:14
    clustalw_output: bool = False      # -clustalw
    annotate: bool = False             # -annot
    align_order: bool = False          # -a


@dataclass
class RealignerConfig:
    """QuickProbs tier (Configuration.cpp defaults)."""

    consistency_reps: int = 2          # small families (threshold 50)
    consistency_reps_large: int = 1
    # numFilterings=-1 default: the LAST relaxation iteration skips the
    # posterior-cutoff filter and re-sparsifies at 1e-5 instead
    # (ConsistencyStage.cpp:230-259)
    consistency_final_cutoff: float = 1e-5
    large_family_threshold: int = 50
    refinement_reps: int = 30          # small (RefinementBase.cpp:32-35)
    refinement_reps_large: int = 200
    refinement_threshold: int = 200
    posterior_cutoff: float = 0.01
    partition_matrix: str = "Vtml200"
    tree_kind: str = "upgma"
    selectivity_mode: str = "subtree"
    selectivity_function: str = "max"
    selectivity_filter: str = "deterministic"
    selectivity: float = 200.0
    selectivity_normalization: str = "no"
    selfweight: float = 3.0
    saturation: float = 1e-6
    final_saturation: float = 1e-6
    refinement_type: str = "column"
    column_fraction: float = 1.0
    max_depth: int = 0
    ignore_terminal_gaps: bool = True
    acceptance_length: bool = True
    acceptance_entropy: bool = False
    autosave_every: int = 0


@dataclass
class EngineConfig:
    """Batching and memory plan (no reference analogue)."""

    length_bucket: int = 128
    topk_per_row: int = 16
    extract_topk: int = 64            # rows pulled from device consistency
    max_batch: int = 256              # pairs per posterior batch, at most
    # budgets on the host (device="cpu"): the JAX package's defaults
    host_plane_budget_bytes: float = 9e9
    host_cons_budget_bytes: float = 4e9
    host_sector_budget_bytes: float = 8e9
    # budgets on the card, as shares of the device memory free at first
    # use: the posterior planes of a batch; the dense (N, N, Lp, Lp)
    # consistency tensor, whose relaxation and top-k extraction hold about
    # two tensor sizes more at their peak (a share set when a dense einsum
    # held about eight: ROADMAP §2 item 2); and one step of the sector
    # relaxation (align/sector.py counts its whole peak), which runs
    # after the posterior batches have freed their planes
    plane_budget_share: float = 0.25
    cons_budget_share: float = 0.1
    sector_budget_share: float = 0.25


@dataclass
class Config:
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    aligner: AlignerConfig = field(default_factory=AlignerConfig)
    realigner: RealignerConfig = field(default_factory=RealignerConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)


DEFAULT = Config()


@functools.lru_cache(maxsize=8)
def engine_budgets(device_type: str, device_index: int | None = None
                   ) -> tuple[int, int, int]:
    """(plane_budget, cons_budget, sector_budget) in bytes for one device.

    On the card they are shares of `torch.cuda.mem_get_info()` read once,
    at first use; on the CPU they are the fixed host figures.
    """
    eng = DEFAULT.engine
    if device_type != "cuda":
        return (int(eng.host_plane_budget_bytes),
                int(eng.host_cons_budget_bytes),
                int(eng.host_sector_budget_bytes))
    import torch

    free, _ = torch.cuda.mem_get_info(device_index)
    return (int(free * eng.plane_budget_share),
            int(free * eng.cons_budget_share),
            int(free * eng.sector_budget_share))
