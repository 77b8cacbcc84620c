"""One run of one cell: set-up, the measured window, the readings, the
correctness check.

A cell (BENCHMARK.json `workloads`) names a configuration
(`configs/<config>.json`: the family shape) and a traffic mix
(`traffic/<traffic>.json`: the program's entry, its environment, the
sample the check draws).  The run warms the entry up on one family of
the configuration's shape, then aligns family 0, 1, 2, ... of the seed
back to back (a closed loop: a suite user aligns one family after
another) until the window's seconds have passed, the family in flight
finished.  For the family that the correctness check draws from the
seed, what the relaxation returns in the window is kept (`check.
RelaxRecorder`).  Metrics are read by `metrics/<name>.py`, each a `read(ctx)`
that returns a number or None.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from msabench import check, generator

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mlprobs_tpu")
# the correctness check's families are drawn among the window's first
# four (the window runs on until they are done; at the cells' shapes it
# completes 7 or more)
CHECK_AMONG = 4


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_reader(name: str):
    """`read` of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"msabench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX package's or JAX's,
    compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The `kind` metrics ("end_to_end" or "per_layer") a cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def apply_env(traffic: dict) -> None:
    """The traffic's environment: a string sets a variable, null unsets
    it."""
    for k, v in traffic.get("env", {}).items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)


@dataclass
class Family:
    k: int
    records: list
    seconds: float
    msa: object
    path: dict
    timers: dict
    launches: dict
    calls: list = field(default_factory=list)
    aligned: list = field(default_factory=list)   # the MSA as records


@dataclass
class Context:
    """What a metric's reader reads."""

    cell: str
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    peak_bytes: int
    families: list
    trace: object = None    # trace.Trace of a traced run


def program_entry(traffic: dict, device):
    """`go(records) -> (msa, path)` through the traffic's entry."""
    if traffic["entry"] == "run_pipeline":
        from mlprobs_tpu_torch.pipeline.driver import run_pipeline

        def go(records):
            msa, rep = run_pipeline(records, device=device)
            keys = ("strategy", "realign_mode", "num_realign_blocks",
                    "blocks_realigned", "blocks_accepted",
                    "whole_family_realign", "crash_fallback",
                    "device_suspect", "error", "engines")
            return msa, {k: getattr(rep, k, None) for k in keys}
        return go
    if traffic["entry"] == "align_family":
        from mlprobs_tpu_torch.align.aligner import align_family

        def go(records):
            eng: dict = {}
            msa = align_family(records, device=device, report=eng,
                               **traffic.get("entry_args", {}))
            return msa, {"engines": eng}
        return go
    raise ValueError(f"entry {traffic['entry']!r}")


def launch_counts() -> dict:
    """Kernel launches counted by the program's wrappers since the last
    reset; a wrapper the program no longer has is left out."""
    from mlprobs_tpu_torch.ops.kernels import qpx_kernel as qk
    from mlprobs_tpu_torch.ops.kernels import viterbi_kernel as vk
    from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as wk

    fns = {"sweep": getattr(wk, "sweep", None),
           "combine": getattr(wk, "combine", None),
           "viterbi": getattr(vk, "viterbi_stats", None),
           "qpx": getattr(qk, "hmm5_fb", None)}
    return {k: f.launches for k, f in fns.items()
            if hasattr(f, "launches")}


def reset_launch_counts() -> None:
    from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as wk

    if hasattr(wk, "reset_launch_counts"):
        wk.reset_launch_counts()


class WorkHooks:
    """Records each call into the posterior stage and the device
    relaxation, with the true lengths it was given, while active: the
    benchmark's own spans around the calls into those layers, from which
    `work.py` counts what the algorithm needs."""

    def __init__(self):
        self.calls: list = []
        self._saved: list = []

    def _wrap(self, owner, name, record):
        fn = getattr(owner, name, None)
        if fn is None:
            return
        self._saved.append((owner, name, fn))

        def wrapped(*a, **k):
            out = fn(*a, **k)
            rec = record(out, *a, **k)
            if rec is not None:
                self.calls.append(rec)
            return out
        setattr(owner, name, wrapped)

    def __enter__(self):
        from mlprobs_tpu_torch.align import pairwise

        qp_exact = os.environ.get("MLPROBS_QP_EXACT", "1") != "0"

        def dense(out, seqs, mode, *a, **k):
            if out is None:
                return None
            n = len(seqs)
            pairs = [(len(seqs[i]), len(seqs[j]))
                     for i in range(n) for j in range(i + 1, n)]
            return ("posteriors", mode, qp_exact, True, pairs)

        def sparse(out, seqs, mode, leave_prob=None, pairs=None, *a, **k):
            n = len(seqs)
            idx = pairs if pairs is not None else [
                (i, j) for i in range(n) for j in range(i + 1, n)]
            return ("posteriors", mode, qp_exact, False,
                    [(len(seqs[i]), len(seqs[j])) for i, j in idx])

        def relax(out, self_, weights=None, selfweight=3.0,
                  selectivity=200.0, reps=2, *a, **k):
            return ("relax", list(self_.seq_lens), reps)

        self._wrap(pairwise, "device_posterior_tensor", dense)
        self._wrap(pairwise, "all_pairs_posteriors", sparse)
        self._wrap(pairwise.DevicePosteriorTensor, "relax_and_extract",
                   relax)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        return False


def run(cell: str, bench: dict, seed: int, seconds: float, traced: bool,
        t0: float, device="cuda", log=print, config=None, traffic=None,
        limits=None) -> dict:
    """One run of `cell`; returns the result line's object.  `t0`: the
    process's start on the host clock (set-up counts from it).  The
    tests pass a small `config`, a `traffic` and `limits` in place of
    the cell's files, and device "cpu"."""
    wl = next(w for w in bench["workloads"] if w["name"] == cell)
    config = config or load_json("configs", wl["config"])
    traffic = traffic or load_json("traffic", wl["traffic"])
    apply_env(traffic)
    import torch

    from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS

    from msabench import trace as tr

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    go = program_entry(traffic, device)
    # ---- set-up: one family of the cell's shape, the same every run ----
    go(generator.family(config["family"], 0, 0, key=generator.WARMUP))
    sync()
    setup_s = time.perf_counter() - t0

    # ---- the measured window -------------------------------------------
    readers = {m["name"]: load_reader(m["name"])
               for m in cell_metrics(bench, cell,
                                     "per_layer" if traced else
                                     "end_to_end")}
    families: list[Family] = []
    # the families the correctness check compares, drawn from the seed
    # among the window's first CHECK_AMONG; what the window's relaxation
    # returns for them is kept
    rng = np.random.default_rng(
        generator.seed_sequence(seed, generator.SAMPLE))
    picks = sorted(int(i) for i in rng.choice(
        CHECK_AMONG, min(traffic.get("sample", 1), CHECK_AMONG),
        replace=False))
    relax = check.RelaxRecorder()
    relax_calls: dict = {}
    hooks = WorkHooks() if traced else None
    prof = tr.Profiled(torch) if traced else None
    spans = tr.SpanRecorder(STATS) if traced else None
    gc.collect()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if traced:
        hooks.__enter__()
        spans.__enter__()
        prof.__enter__()
    relax.__enter__()
    w0 = time.perf_counter()
    k = 0
    while True:
        records = generator.family(config["family"], seed, k)
        STATS.reset()
        reset_launch_counts()
        if traced:
            hooks.calls = []
        relax.armed = k in picks
        relax.calls = []
        f0 = time.perf_counter()
        msa, path = go(records)
        sync()
        f1 = time.perf_counter()
        if relax.armed:
            relax_calls[k] = relax.calls
        families.append(Family(k, records, f1 - f0, msa, path,
                               dict(STATS.timers), launch_counts(),
                               hooks.calls if traced else []))
        k += 1
        if f1 - w0 >= seconds and k > picks[-1]:
            break
    window_s = f1 - w0
    relax.__exit__(None, None, None)
    trace = None
    if traced:
        prof.__exit__(None, None, None)
        spans.__exit__(None, None, None)
        hooks.__exit__(None, None, None)
        trace = prof.trace(spans.spans)
        del prof
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    failed = 0
    invalid = 0
    for f in families:
        f.aligned = f.msa.to_records()
        ok = check.degapped_ok(f.records, f.aligned)
        bad = (not ok or bool(f.path.get("crash_fallback"))
               or bool(f.path.get("device_suspect")))
        invalid += not ok
        failed += bad
        info = " ".join(f"{k}={v}" for k, v in f.path.items()
                        if k not in ("engines", "error") or v)
        log(f"[family {f.k}] {f.seconds:.4f} s valid={ok} {info} "
            f"launches={f.launches} stages="
            + json.dumps({k: round(v, 4) for k, v in f.timers.items()}),
            file=sys.stderr)
        f.msa = None
    ctx = Context(cell, config, traffic, setup_s, window_s, peak,
                  families, trace)
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    for name, read in readers.items():
        value = read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}

    # ---- the correctness check, once the window's state is freed --------
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    lim = limits or check.limits(cell)
    gaps, rgaps = [], []
    for i in picks:
        f = families[i]
        r0 = time.perf_counter()
        ref = check.reference(traffic, f.records, device)
        gaps.append(check.sp_gap(f.aligned, ref.records))
        rgaps.append(check.relax_gap(relax_calls[i], ref.relax,
                                     ref.relax_hi))
        log(f"[check] family {f.k}: reference in "
            f"{time.perf_counter() - r0:.1f} s, sp_gap {gaps[-1]!r}, "
            f"relax_gap {rgaps[-1]!r} over {len(ref.relax)} relaxation "
            f"call(s)", file=sys.stderr)
        del ref
    checks = {
        "failed_families": [failed, lim["failed_families"]],
        "invalid_msas": [invalid, lim["invalid_msas"]],
        "relax_gap": [max(rgaps), lim["relax_gap"]],
        "sp_gap": [max(gaps), lim["sp_gap"]],
    }
    correct = all(v <= limit for v, limit in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(families),
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(10),
                               "idle_gaps": trace.idle_by_span(10)}
    result["checks"] = {k: {"value": v, "limit": limit}
                        for k, (v, limit) in checks.items()}
    return result
