"""Multi-process initialisation and family scheduling.

The counterpart of the JAX package's `parallel/distributed.py`.  The
reference is single-process; multi-process here means (a) a
`torch.distributed` process group across processes or hosts, and (b) an
embarrassingly parallel per-family scheduler for suite runs, striping
families across processes.  The pair stages need neither: one process
drives every card of its pairs mesh (parallel/mesh.py).
"""
from __future__ import annotations

import os


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> tuple[int, int]:
    """Join the process group of `coordinator` ("host:port"), from the
    arguments or MLPROBS_COORDINATOR, MLPROBS_NUM_PROCESSES and
    MLPROBS_PROCESS_ID.

    Returns (process_id, num_processes): (0, 1) with no process group
    when no coordinator is set.  The group's backend is NCCL for a run on
    the card and gloo when the caller asks for the CPU.
    """
    import torch
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("MLPROBS_COORDINATOR")
    if not coordinator:
        return 0, 1
    num_processes = int(
        num_processes or os.environ.get("MLPROBS_NUM_PROCESSES", "1")
    )
    process_id = int(
        process_id if process_id is not None
        else os.environ.get("MLPROBS_PROCESS_ID", "0")
    )
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
    )
    return process_id, num_processes


def my_families(files: list, process_id: int, num_processes: int) -> list:
    """Stripe families across processes (round-robin by sorted order)."""
    return [f for k, f in enumerate(sorted(files))
            if k % num_processes == process_id]
