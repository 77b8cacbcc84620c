"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
 1. device: the card's name and power limit, torch and CUDA versions;
 2. build: both kernels from the repository's .cu sources with nvcc;
 3. kernels against their plain PyTorch versions on the card, for every
    model set, at Lp=512/B=64 and Lp=128/B=3: sweep planes, scales and
    totals; dense combine; the fused top-k against `topk_skew` of the
    kernel's own dense plane; MWT match counts.  The sweep's scales must
    equal the plain version's in every row.  Then each kernel's time at
    the main path's shapes beside its plain version's and its bound
    (combine in each mode: dense, with match counts, top-k 16, and dense
    again at the family's last batch size), and the sweep's time for
    each single-model set;
 4. the main path: a seeded twilight-zone family (N=48, 330-470
    residues) through `align_family(config="pnp")` on the card, with
    the kernels' launch counts, per-stage wall clock and peak memory;
    then one torch.profiler window around the family's posterior tensor
    (the five device operations with the most time, the device's idle
    share), and the consistency tensor rebuilt with the plain versions
    on the card must agree with the kernels' tensor;
 5. [qp]: the realigner's qp posterior (`_qpx_combined_skew`: the qpx
    hmm5 posterior in plain torch, the partition half through the sweep
    kernel) on the card against the CPU plain version at Lp=128/B=8
    (atol 2e-4); then at the smoke family's qp shape (Lp=512, its batch
    size) the times of the qpx forward+backward, of the two partition
    sweeps and of the whole qp batch, its peak bytes against the batch
    budget of 80 bytes per (pair, cell), the qpx time at B=32 beside
    B=256 and one profiler window around a qpx pass (Lp=128, B=256);
 6. [pipeline]: `run_pipeline` (the `cli align` path) on the smoke family
    on the card: decisions, stage marks, launches, hash, peak bytes; no
    crash fallback, no block error, rows degap to the inputs;
 7. [realigner]: `align_family(config="quickprobs")` on the smoke family
    on the card (per-stage seconds, engines, hash, peak bytes), unless
    phase 6 already took the whole-family realign, whose numbers it then
    prints; the consistency must run on the device;
 8. [pipeline-cpu]: `run_pipeline` on a small seeded family on the card
    and on the CPU, as classified and with classifier 3 forced to RIR
    (blocks realigned on the card): equal decisions, both hashes
    printed; then a two-sequence realign (the sparse qp route);
 9. [np]: the non-progressive base aligner (`cli base -p 1`,
    `align_family(strategy=1)`) on the smoke family on the card: validity,
    stage timers, launches, graph nodes, peak bytes, hash; then
    `run_pipeline` on a family that classifier 1 sends to the NP
    strategy, on the card and the CPU: strategy 1 and equal hashes;
10. [sector]: `align_family(config="pnp")` on a 96-sequence family whose
    dense tensor is over its budget: the consistency must run by sectors
    on the card, with no downgrade; block size, sector count, predicted
    against measured peak bytes, relaxation time, hash; then a sector
    relaxation forced into several blocks on the card against the same
    call on the CPU (atol 2e-4);
11. [long]: both kernels at B=1, Lp=8,192 and 8,320 (the long family's
    length, past the short instances) against their plain versions,
    their times at B=1 up to Lp=16,384; then `cli base` on a
    three-sequence family with one sequence of 8,250 residues (every
    pair past 8,192 lanes or beside it): wall time, stage timers,
    validity, launches.
Each path is driven with the launch counts set to 0 just before it and
read just after; a path that launched none of its kernels fails.
Before the last line come the kernels' JSON record and the nvidia-smi
line; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

CARD_F32_OPS = 67e12        # H100 SXM f32 (non-tensor) peak, op/s
CARD_BYTES = 3.35e12        # H100 SXM HBM3 bandwidth, bytes/s
# f32 adds, multiplies, max/min and square roots per DP cell, counted
# from the kernels (selects and integer index arithmetic not counted):
# csrc/sweep.cu per model (recurrences, block max, rescale, emit and the
# neighbour sums); csrc/combine.cu per model (split multiply, clamp,
# square-accumulate) and per cell (RMS and the MWT step)
SWEEP_OPS = {"hmm5": 46, "local": 25, "partition": 17}
COMBINE_OPS_PER_MODEL, COMBINE_OPS_CELL = 6, 8
TOL = {
    "plane": 1e-5,      # sweep planes on one scale, relative to the row max
    "l2t": 2e-4,        # log2 totals: 2e-4 in log2 ~ 1.4e-4 relative
    "post": 2e-4,       # posterior planes: the JAX package's own bound
    "score_rtol": 1e-4, "score_atol": 1e-3,
    "topk": 1e-7,
}
MODEL_SETS = {
    "mix": ("hmm5", "partition", "local"),
    "qp": ("hmm5", "partition"),
    "hmm5": ("hmm5",),
    "local": ("local",),
    "partition": ("partition",),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ptxas_summary(log: str) -> list:
    """One line per kernel instance of an `nvcc -Xptxas -v` log: its
    (demangled) name, registers and spill bytes; error lines as they are."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        if "error" in line:
            out.append(line.strip())
        elif "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
            try:
                name = subprocess.run(["c++filt", name], capture_output=True,
                                      text=True, timeout=10).stdout.strip()
            except (OSError, subprocess.SubprocessError):
                pass
            name = name.replace("(anonymous namespace)::", "").split("(")[0]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            out.append(f"{name}: {regs} registers; {spill}")
    return out


def profiled(fn):
    """(fn(), record): one torch.profiler window (CPU + CUDA) around fn;
    the record has the window's wall time, the five device operations
    with the most time and the device's idle share (1 - the union of the
    device intervals over the window).  Without device events the device
    numbers read "not measured" and the record carries the CUDA-event
    time of the window instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rec = {"window_ms": wall_us / 1e3,
           "cuda_event_ms": start.elapsed_time(end)}
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        rec["top_device_ops"] = rec["device_idle_share"] = "not measured"
        return out, rec
    per_name: dict = {}
    for e in dev:
        per_name[e.name] = (per_name.get(e.name, 0.0)
                            + e.time_range.elapsed_us())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    rec["top_device_ops"] = [{"name": n[:80], "ms": us / 1e3}
                             for n, us in top]
    rec["device_busy_ms"] = busy / 1e3
    rec["device_idle_share"] = max(0.0, 1.0 - busy / wall_us)
    return out, rec


def ops_per_diagonal(fn, lp: int) -> float:
    """Non-view aten ops that fn() dispatches, over its 2*lp+1 diagonals
    (each a device launch on the card, but for a few host-side scalars)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ret = func._schema.returns
            if not (ret and ret[0].alias_info is not None
                    and not ret[0].alias_info.is_write):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n / (2 * lp + 1)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    try:
        from mlprobs_tpu_torch.align import aligner, pairwise
        from mlprobs_tpu_torch.core.alphabet import degap, encode
        from mlprobs_tpu_torch.models import forests
        from mlprobs_tpu_torch.ops import qpx
        from mlprobs_tpu_torch.ops.kernels import build
        from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as wk
        from mlprobs_tpu_torch.pipeline.driver import run_pipeline
        from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS
        from mlprobs_tpu_torch.utils.synth import synthetic_family
    except ImportError as e:
        fail(f"the mlprobs_tpu_torch package is not beside this script: {e}")

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {smi} | torch {torch.__version__} | "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 2. build --------------------------------------------------------
    info = build.build_all()
    print(f"[build] sweep+combine nvcc in {info['seconds']:.2f} s", flush=True)
    for name, log in info["logs"].items():
        for line in ptxas_summary(log):
            print(f"[build:{name}] {line}")
    wk.reset_launch_counts()

    # ---- 3. kernels against their plain versions -------------------------
    def batch(lp, b, seed):
        rng = torch.Generator().manual_seed(seed)
        lens = torch.randint(lp // 2, lp + 1, (b,), generator=rng)
        lens[0] = lp
        X = torch.full((b, lp), 20, dtype=torch.int8)
        Y = torch.full((b, lp), 20, dtype=torch.int8)
        ly = torch.randint(lp // 2, lp + 1, (b,), generator=rng)
        for k in range(b):
            X[k, : lens[k]] = torch.randint(0, 20, (int(lens[k]),),
                                            generator=rng)
            Y[k, : ly[k]] = torch.randint(0, 20, (int(ly[k]),),
                                          generator=rng)
        return (X.to(dev), Y.to(dev), lens.to(torch.int32).to(dev),
                ly.to(torch.int32).to(dev))

    def sweeps(fn, X, Y, LX, LY, tabs_f, tabs_r, models):
        b, lp = X.shape
        zero = torch.zeros((b,), dtype=torch.int32, device=dev)
        rev = fn(X.flip(1).contiguous(), Y.flip(1).contiguous(),
                 (lp - LX).to(torch.int32), (lp - LY).to(torch.int32),
                 LX, LY, tabs_r, models=models, emit_pre=True)
        fwd = fn(X, Y, zero, zero, LX, LY, tabs_f, models=models)
        return fwd, rev

    def plane_err(k, p, m):
        # the kernel's stored values on the plain version's scale, the
        # largest difference in a row over the row's max
        shift = (k["scales"][m] - p["scales"][m])[:, :, None]
        a = k["planes"][m] * torch.exp2(-shift)
        rowmax = p["planes"][m].abs().amax(dim=2).clamp(min=1e-38)
        err = (a - p["planes"][m]).abs().amax(dim=2) / rowmax
        return float(err.max())

    def grid_mask(D, W, LX, LY):
        d = torch.arange(D, device=dev)[:, None, None]
        j = torch.arange(W, device=dev)[None, None, :]
        i = d - j
        return ((j >= 1) & (j <= LY[None, :, None])
                & (i >= 1) & (i <= LX[None, :, None]))

    worst = {"sweep": 0.0, "combine": 0.0}
    for lp, b in ((512, 64), (128, 3)):
        X, Y, LX, LY = batch(lp, b, seed=lp + b)
        for mode, models in MODEL_SETS.items():
            tabs_f, tabs_r = pairwise._wf_tables(
                "qp" if mode == "qp" else "mix", 0.17, dev)
            fk, rk = sweeps(wk.sweep, X, Y, LX, LY, tabs_f, tabs_r, models)
            fp, rp = sweeps(wk.sweep_reference, X, Y, LX, LY, tabs_f,
                            tabs_r, models)
            e_plane = max(max(plane_err(fk, fp, m), plane_err(rk, rp, m))
                          for m in models)
            e_l2t = max(float((k["log2t"][m] - p["log2t"][m]).abs().max())
                        for k, p in ((fk, fp), (rk, rp)) for m in models)
            scale_rows = sum(
                int((k["scales"][m] != p["scales"][m]).sum())
                for k, p in ((fk, fp), (rk, rp)) for m in models)
            # combine on the kernel sweeps' outputs, both ways
            post_k, sc_k, nb_k = wk.combine(fk, rk, LX, LY, models,
                                            with_matches=True)
            post_p, sc_p, nb_p = wk.combine_reference(
                fk, rk, LX, LY, models, with_matches=True)
            e_post = float((post_k - post_p).abs().max())
            outside = ~grid_mask(post_k.shape[0], post_k.shape[2], LX, LY)
            pad_nonzero = int((post_k[outside] != 0).sum())
            score_ok = torch.allclose(sc_k, sc_p, rtol=TOL["score_rtol"],
                                      atol=TOL["score_atol"])
            nb_ok = bool(torch.equal(nb_k, nb_p))
            # the fused top-k with match counts, the NP path's mode
            vals_k, lanes_k, sc_t, nb_t = wk.combine(
                fk, rk, LX, LY, models, with_matches=True, topk=16,
                cutoff=0.01)
            vals_w, lanes_w = wk.wf.topk_skew(post_k, 16, 0.01)
            e_topk = float((vals_k - vals_w).abs().max())
            pos = vals_w > 0
            lanes_ok = bool(torch.equal(lanes_k[pos], lanes_w[pos]))
            rec = {"lp": lp, "b": b, "models": mode, "plane_err": e_plane,
                   "l2t_err": e_l2t, "scale_rows_differing": scale_rows,
                   "post_err": e_post, "pad_nonzero": pad_nonzero,
                   "score_ok": score_ok, "matches_equal": nb_ok,
                   "topk_err": e_topk, "topk_lanes_equal": lanes_ok,
                   "topk_score_equal": bool(torch.equal(sc_t, sc_k)),
                   "topk_matches_equal": bool(torch.equal(nb_t, nb_p))}
            print("[check] " + json.dumps(rec), flush=True)
            # the sweep keeps the plain version's scales bit for bit
            ok = (e_plane <= TOL["plane"] and e_l2t <= TOL["l2t"]
                  and scale_rows == 0
                  and e_post <= TOL["post"] and pad_nonzero == 0
                  and score_ok and nb_ok and e_topk <= TOL["topk"]
                  and lanes_ok and rec["topk_score_equal"]
                  and rec["topk_matches_equal"])
            if not ok:
                fail(f"kernel disagrees with its plain version: {rec}")
            worst["sweep"] = max(worst["sweep"], e_plane)
            worst["combine"] = max(worst["combine"], e_post)

    # timing at the main path's shapes: Lp=512, the budgeted batch, mix
    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e))
        return statistics.median(out)

    lp = 512
    models = MODEL_SETS["mix"]
    b = pairwise._wf_batch_size(lp, dev)
    X, Y, LX, LY = batch(lp, b, seed=7)
    tabs_f, tabs_r = pairwise._wf_tables("mix", 0.17, dev)
    zero = torch.zeros((b,), dtype=torch.int32, device=dev)
    fk, rk = sweeps(wk.sweep, X, Y, LX, LY, tabs_f, tabs_r, models)
    D, W, nm = 2 * lp + 1, lp + 1, len(models)
    # combine in each of its modes, and dense again on the family's last
    # batch (B=104: 1,128 pairs = 4 x 256 + 104)
    b_last = 104
    X2, Y2, LX2, LY2 = (t[:b_last].contiguous() for t in (X, Y, LX, LY))
    fk2, rk2 = sweeps(wk.sweep, X2, Y2, LX2, LY2, tabs_f, tabs_r, models)
    comb_modes = {
        # name: (fwd, rev, lx, ly, keyword arguments)
        "combine": (fk, rk, LX, LY, {}),
        "combine_matches": (fk, rk, LX, LY, {"with_matches": True}),
        "combine_topk16": (fk, rk, LX, LY, {"topk": 16, "cutoff": 0.01}),
        "combine_b104": (fk2, rk2, LX2, LY2, {}),
    }
    timing = {
        "sweep": (
            cuda_ms(lambda: wk.sweep(X, Y, zero, zero, LX, LY, tabs_f,
                                     models=models), 7),
            cuda_ms(lambda: wk.sweep_reference(X, Y, zero, zero, LX, LY,
                                               tabs_f, models=models), 3),
        ),
    }
    for name, (f_, r_, lx_, ly_, kw) in comb_modes.items():
        timing[name] = (
            cuda_ms(lambda: wk.combine(f_, r_, lx_, ly_, models, **kw), 7),
            cuda_ms(lambda: wk.combine_reference(f_, r_, lx_, ly_, models,
                                                 **kw), 3),
        )

    def bound(nbytes, ops):
        tb, to = nbytes / CARD_BYTES * 1e3, ops / CARD_F32_OPS * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    def comb_bound(bb, with_matches=False, topk=0, cutoff=None):
        # each input read once (2 x nm planes, scales and totals, lx, ly),
        # each output written once: the dense plane, or k values and k
        # lanes a diagonal; the score, and the match counts when asked
        out = D * bb * (topk * 8 if topk else W * 4)
        nbytes = (2 * nm * (D * bb * W + D * bb + bb) * 4 + 8 * bb + out
                  + 4 * bb * (2 if with_matches else 1))
        ops = (COMBINE_OPS_PER_MODEL * nm + COMBINE_OPS_CELL) * D * W * bb
        return bound(nbytes, ops)

    sweep_bytes = 2 * b * lp + 16 * b + nm * (D * b * W + D * b + b) * 4
    sweep_ops = sum(SWEEP_OPS[m] for m in models) * D * W * b
    bounds = {"sweep": bound(sweep_bytes, sweep_ops)}
    for name, args in comb_modes.items():
        bounds[name] = comb_bound(args[2].shape[0], **args[4])
    # the sweep of each single-model set on the same batch: which kind
    # sets the pace of the mix launch
    single = {m: cuda_ms(lambda m=m: wk.sweep(X, Y, zero, zero, LX, LY,
                                              tabs_f, models=(m,)), 7)
              for m in models}
    rec = {k: {"ms": v[0], "plain_ms": v[1], "bound_ms": bounds[k][0]}
           for k, v in timing.items()}
    rec["sweep_single_ms"] = single
    print(f"[timing] mix Lp={lp} B={b} (combine_b104: B={b_last}): "
          + json.dumps(rec), flush=True)
    del fk, rk, fk2, rk2, comb_modes, f_, r_, X2, Y2, LX2, LY2

    # ---- 4. the main path --------------------------------------------------
    records = synthetic_family(48, 330, 470, sub=0.5, indel=0.1, seed=48)
    report: dict = {}
    STATS.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    msa = aligner.align_family(records, config="pnp", strategy=0,
                               report=report, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"sweep": wk.sweep.launches, "combine": wk.combine.launches}
    peak = torch.cuda.max_memory_allocated()
    stages = {k[5:]: v for k, v in STATS.to_dict().items()
              if k.startswith("time.")}
    print("[main] " + json.dumps({
        "family": "synthetic N=48 L=330-470 sub=0.5 indel=0.1 seed=48",
        "wall_s": wall, "stages_s": stages, "launches": launches,
        "peak_device_bytes": peak, "report": report,
        "content_hash": msa.content_hash(), "columns": msa.length,
    }), flush=True)
    if min(launches.values()) < 1:
        fail(f"the main path did not run every kernel: {launches}")
    if report.get("consistency_engine") != "device" \
            or "consistency_downgrade" in report:
        fail(f"consistency left the device: {report}")
    if report.get("mode") != "mix":
        fail(f"the smoke family is not in the mix regime: {report}")
    by_header = dict(records)
    for hdr, row in msa.to_records():
        if row.replace("-", "") != by_header[hdr]:
            fail(f"row {hdr} does not degap to its input")
    if len({len(r) for _, r in msa.to_records()}) != 1 \
            or msa.num_seqs != len(records):
        fail("ragged or incomplete alignment")

    # consistency tensor: kernels against plain versions, on the card
    seqs = [degap(encode(s)) for _, s in records]
    stats = aligner.family_viterbi_stats(seqs, device=dev)
    leave = aligner.mp.adaptive_leave_prob(stats.avg_pid)
    t_k, prof = profiled(lambda: pairwise.device_posterior_tensor(
        seqs, "mix", leave, device=dev))
    print("[profile] device_posterior_tensor of the smoke family: "
          + json.dumps(prof), flush=True)
    saved = wk.sweep, wk.combine
    wk.sweep, wk.combine = wk.sweep_reference, wk.combine_reference
    try:
        t_p = pairwise.device_posterior_tensor(seqs, "mix", leave,
                                               device=dev)
    finally:
        wk.sweep, wk.combine = saved
    both = (t_k.S > 0) == (t_p.S > 0)
    e_both = float((t_k.S - t_p.S)[both].abs().max())
    # a cell kept by one side only sits at the cutoff on the other
    one = t_k.S[~both] + t_p.S[~both]
    e_edge = float((one - 0.01).abs().max()) if one.numel() else 0.0
    e_dist = float(abs(t_k.dist - t_p.dist).max())
    rec = {"tensor_err": e_both, "cutoff_edge_cells": int(one.numel()),
           "cutoff_edge_err": e_edge, "dist_err": e_dist}
    print("[tensor] " + json.dumps(rec), flush=True)
    if e_both > TOL["post"] or e_edge > TOL["post"] or e_dist > 1e-5:
        fail(f"consistency tensor: kernels disagree with plain: {rec}")
    del t_k, t_p, both, one

    # ---- 5. [qp]: the realigner's posterior batch ---------------------------
    qtf, qtr = pairwise._wf_tables("qp", None, dev)
    qtf_c, qtr_c = pairwise._wf_tables("qp", None, "cpu")
    X, Y, LX, LY = batch(128, 8, seed=128)
    cpu_args = [t.cpu() for t in (X, Y, LX, LY)]
    p5 = pairwise._qpx_params(dev)
    ph_k = qpx.hmm5_posterior_qpx(X, Y, LX, LY, *p5)
    ph_c = qpx.hmm5_posterior_qpx(*cpu_args, *pairwise._qpx_params(
        torch.device("cpu")))
    post_k = pairwise._qpx_combined_skew(X, Y, LX, LY, qtf, qtr)
    post_c = pairwise._qpx_combined_skew(*cpu_args, qtf_c, qtr_c)
    qp_err = float((post_k.cpu() - post_c).abs().max())
    qp_rec = {"lp": 128, "b": 8, "qp_post_err": qp_err,
              "hmm5_qpx_err": float((ph_k.cpu() - ph_c).abs().max())}
    print("[qp] card vs cpu: " + json.dumps(qp_rec), flush=True)
    if qp_err > TOL["post"]:
        fail(f"qp posterior on the card disagrees with the CPU: {qp_rec}")
    del ph_k, ph_c, post_k, post_c

    lp = 512
    bq = pairwise._wf_batch_size(lp, dev)
    X, Y, LX, LY = batch(lp, bq, seed=11)
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_batch = cuda_ms(lambda: pairwise._qpx_combined_skew(
        X, Y, LX, LY, qtf, qtr), 1)
    qp_peak = torch.cuda.max_memory_allocated() - base_bytes
    t_fb = cuda_ms(lambda: qpx.hmm5_fb_qpx(X, Y, LX, LY, *p5), 1)
    t_sw = cuda_ms(lambda: wk.sweeps(X, Y, LX, LY, qtf, qtr,
                                     ("partition",)), 3)
    Xs, Ys, LXs, LYs = (t[:32].contiguous() for t in (X, Y, LX, LY))
    t_fb32 = cuda_ms(lambda: qpx.hmm5_fb_qpx(Xs, Ys, LXs, LYs, *p5), 1)
    del Xs, Ys, LXs, LYs
    per_cell = qp_peak / (bq * lp * lp)
    qp_rec = {"lp": lp, "b": bq, "qpx_fb_ms": t_fb,
              "partition_sweeps_ms": t_sw, "qp_batch_ms": t_batch,
              "qpx_fb_ms_b32": t_fb32, "peak_bytes": qp_peak,
              "peak_bytes_per_pair_cell": per_cell, "budget_per_cell": 80}
    print("[qp] timing: " + json.dumps(qp_rec), flush=True)
    if per_cell > 80:
        fail(f"a qp batch outgrows the batch budget: {qp_rec}")
    Xp, Yp, LXp, LYp = batch(128, 256, seed=12)
    _, prof = profiled(lambda: qpx.hmm5_fb_qpx(Xp, Yp, LXp, LYp, *p5))
    small_batch = batch(64, 4, seed=13)
    prof["ops_per_diagonal_pair"] = ops_per_diagonal(
        lambda: qpx.hmm5_fb_qpx(*small_batch, *p5), 64)
    print("[qp] profile of one qpx forward+backward (Lp=128, B=256): "
          + json.dumps(prof), flush=True)
    del X, Y, LX, LY, Xp, Yp, LXp, LYp

    def valid_msa(msa, recs):
        rows = dict(msa.to_records())
        return (msa.num_seqs == len(recs)
                and len({len(r) for r in rows.values()}) == 1
                and all(rows.get(h, "").replace("-", "") == q
                        for h, q in recs))

    def drive(fn):
        """(result, wall s, launches, peak bytes, stage timers) of one
        path, the launch counts set to 0 just before it."""
        STATS.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wk.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ = time.perf_counter() - t0
        launched = {"sweep": wk.sweep.launches,
                    "combine": wk.combine.launches}
        timers = {k[5:]: v for k, v in STATS.to_dict().items()
                  if k.startswith("time.")}
        return out, wall_, launched, torch.cuda.max_memory_allocated(), \
            timers

    # ---- 6. [pipeline]: cli align's path on the smoke family -------------
    (pmsa, prep), pwall, plaunch, ppeak, ptimers = drive(
        lambda: run_pipeline(records, device="cuda"))
    decisions = {k: getattr(prep, k) for k in (
        "strategy", "realign_mode", "min_length_class", "num_realign_blocks",
        "blocks_realigned", "blocks_accepted", "whole_family_realign",
        "crash_fallback", "device_suspect")}
    print("[pipeline] " + json.dumps({
        "family": "synthetic N=48 L=330-470 sub=0.5 indel=0.1 seed=48",
        "wall_s": pwall, "decisions": decisions, "marks_s": prep.timings,
        "factor": prep.factor, "avg_pid": prep.avg_pid,
        "stage_timers_s": ptimers, "launches": plaunch,
        "peak_device_bytes": ppeak, "engines": prep.engines,
        "final_hash": prep.final_hash, "columns": pmsa.length,
        "block_errors": prep.block_errors, "error": prep.error,
    }, default=float), flush=True)
    if prep.crash_fallback or prep.block_errors:
        fail(f"the pipeline fell back or lost a block: {prep.error} "
             f"{prep.block_errors}")
    if not valid_msa(pmsa, records):
        fail("the pipeline's MSA does not degap to its input records")
    if min(plaunch.values()) < 1:
        fail(f"the pipeline did not run every kernel: {plaunch}")

    # ---- 7. [realigner]: align_family(config="quickprobs") ---------------
    if prep.whole_family_realign:
        qstages = {k: v for k, v in ptimers.items() if k.startswith("qp_")}
        qrec = {"source": "phase [pipeline]: whole-family realign",
                "stages_s": qstages, "engines": prep.engines,
                "content_hash": prep.final_hash,
                "peak_device_bytes": ppeak, "launches": plaunch}
        qengine = prep.engines.get("consistency_engine")
    else:
        qreport: dict = {}
        qmsa, qwall, qlaunch, qpeak, qtimers = drive(
            lambda: aligner.align_family(records, config="quickprobs",
                                         report=qreport, device="cuda"))
        qrec = {"wall_s": qwall,
                "stages_s": {k: v for k, v in qtimers.items()
                             if k.startswith("qp_")},
                "engines": qreport, "content_hash": qmsa.content_hash(),
                "peak_device_bytes": qpeak, "launches": qlaunch}
        qengine = qreport.get("consistency_engine")
        if not valid_msa(qmsa, records):
            fail("the realigner's MSA does not degap to its input records")
        if qlaunch["sweep"] < 1:
            fail(f"the realigner did not run the sweep kernel: {qlaunch}")
    print("[realigner] " + json.dumps(qrec, default=float), flush=True)
    if qengine != "device":
        fail(f"the realigner's consistency left the device: {qrec}")

    # ---- 8. [pipeline-cpu]: the same decisions on the card and the CPU ---
    # The small family takes the whole-family realign, as the smoke family
    # does; its second run forces classifier 3 to RIR (as the CPU tests
    # do) so that the block realign runs on the card too.
    small = synthetic_family(6, 40, 90, sub=0.2, indel=0.05, seed=5)
    keys = ("strategy", "realign_mode", "min_length_class",
            "num_realign_blocks", "blocks_realigned", "blocks_accepted",
            "whole_family_realign", "crash_fallback")
    real_rs = forests.classify_realign_strategy
    for case in ("as-classified", "rir-forced"):
        if case == "rir-forced":
            forests.classify_realign_strategy = lambda *a: 1
        try:
            (cmsa, crep), cwall, claunch, _, _ = drive(
                lambda: run_pipeline(small, device="cuda"))
            t0 = time.perf_counter()
            hmsa, hrep = run_pipeline(small, device="cpu")
            hwall = time.perf_counter() - t0
        finally:
            forests.classify_realign_strategy = real_rs
        dec_c = {k: getattr(crep, k) for k in keys}
        dec_h = {k: getattr(hrep, k) for k in keys}
        print("[pipeline-cpu] " + json.dumps({
            "family": "synthetic N=6 L=40-90 sub=0.2 indel=0.05 seed=5",
            "case": case,
            "cuda": {"wall_s": cwall, "hash": crep.final_hash,
                     "launches": claunch, "decisions": dec_c,
                     "block_errors": crep.block_errors},
            "cpu": {"wall_s": hwall, "hash": hrep.final_hash,
                    "decisions": dec_h},
            "hashes_equal": crep.final_hash == hrep.final_hash,
        }), flush=True)
        if dec_c != dec_h:
            fail(f"decisions differ between the card and the CPU: "
                 f"{dec_c} vs {dec_h}")
        if crep.crash_fallback or crep.block_errors:
            fail(f"the small family fell back or lost a block: "
                 f"{crep.error} {crep.block_errors}")
        if not (valid_msa(cmsa, small) and valid_msa(hmsa, small)):
            fail("a small-family MSA does not degap to its input records")
        if min(claunch.values()) < 1:
            fail(f"the small family's pipeline did not run every kernel: "
                 f"{claunch}")
    # a two-sequence block: the realigner's sparse (top-k) qp route
    pair = small[:2]
    tmsa, _, tlaunch, _, _ = drive(
        lambda: aligner.align_family(pair, config="quickprobs",
                                     device="cuda"))
    tcpu = aligner.align_family(pair, config="quickprobs", device="cpu")
    print("[pipeline-cpu] " + json.dumps({
        "case": "two-sequence realign", "launches": tlaunch,
        "cuda_hash": tmsa.content_hash(), "cpu_hash": tcpu.content_hash(),
        "hashes_equal": tmsa.content_hash() == tcpu.content_hash(),
    }), flush=True)
    if not valid_msa(tmsa, pair) or tlaunch["sweep"] < 1:
        fail(f"the two-sequence realign failed on the card: {tlaunch}")

    # ---- 9. [np]: the non-progressive base aligner ------------------------
    nrep: dict = {}
    nmsa, nwall, nlaunch, npeak, ntimers = drive(
        lambda: aligner.align_family(records, config="pnp", strategy=1,
                                     report=nrep, device="cuda"))
    print("[np] " + json.dumps({
        "family": "synthetic N=48 L=330-470 sub=0.5 indel=0.1 seed=48",
        "entry": "cli base -p 1 (align_family config=pnp strategy=1)",
        "wall_s": nwall, "valid": valid_msa(nmsa, records),
        "stages_s": ntimers, "launches": nlaunch, "report": nrep,
        "graph_nodes": nrep.get("graph_nodes"),
        "peak_device_bytes": npeak, "content_hash": nmsa.content_hash(),
        "columns": nmsa.length,
    }, default=float), flush=True)
    if not valid_msa(nmsa, records):
        fail("the NP base MSA does not degap to its input records")
    if min(nlaunch.values()) < 1:
        fail(f"the NP path did not run every kernel: {nlaunch}")
    np_family = synthetic_family(16, 12, 24, sub=0.5, indel=0.1, seed=2)
    (cmsa, crep), cwall, claunch, _, _ = drive(
        lambda: run_pipeline(np_family, device="cuda"))
    t0 = time.perf_counter()
    hmsa, hrep = run_pipeline(np_family, device="cpu")
    hwall = time.perf_counter() - t0
    rec = {"family": "synthetic N=16 L=12-24 sub=0.5 indel=0.1 seed=2",
           "cuda": {"wall_s": cwall, "strategy": crep.strategy,
                    "hash": crep.final_hash, "launches": claunch,
                    "engines": crep.engines, "error": crep.error},
           "cpu": {"wall_s": hwall, "strategy": hrep.strategy,
                   "hash": hrep.final_hash},
           "hashes_equal": crep.final_hash == hrep.final_hash}
    print("[np] run_pipeline: " + json.dumps(rec, default=float), flush=True)
    if crep.strategy != 1 or hrep.strategy != 1:
        fail(f"classifier 1 did not send the NP family to NP: {rec}")
    if crep.final_hash != hrep.final_hash or crep.crash_fallback \
            or crep.block_errors or not valid_msa(cmsa, np_family):
        fail(f"the NP family's pipeline differs on the card: {rec}")
    if min(claunch.values()) < 1:
        fail(f"the NP family's pipeline did not run every kernel: {claunch}")

    # ---- 10. [sector]: a family over the dense tensor's budget -------------
    big = synthetic_family(96, 330, 470, sub=0.5, indel=0.1, seed=96)
    srep: dict = {}
    relax_real = aligner.sectorlib.relax_sector_device
    relax_seen: dict = {}

    def relax_measured(*a, **kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = relax_real(*a, **kw)
        torch.cuda.synchronize()
        relax_seen["seconds"] = time.perf_counter() - t0
        relax_seen["peak_bytes_above_base"] = (
            torch.cuda.max_memory_allocated() - base)
        return out

    aligner.sectorlib.relax_sector_device = relax_measured
    try:
        smsa, swall, slaunch, _, stimers = drive(
            lambda: aligner.align_family(big, config="pnp", report=srep,
                                         device="cuda"))
    finally:
        aligner.sectorlib.relax_sector_device = relax_real
    plan = srep.get("sector", {})
    rec = {"family": "synthetic N=96 L=330-470 sub=0.5 indel=0.1 seed=96",
           "wall_s": swall, "stages_s": stimers, "launches": slaunch,
           "engine": srep.get("consistency_engine"),
           "downgrade": srep.get("consistency_downgrade"), "plan": plan,
           "relaxation_s": relax_seen.get("seconds"),
           "measured_peak_bytes": relax_seen.get("peak_bytes_above_base"),
           "valid": valid_msa(smsa, big), "content_hash": smsa.content_hash()}
    print("[sector] " + json.dumps(rec, default=float), flush=True)
    if srep.get("consistency_engine") != "sector" or not str(
            srep.get("consistency_downgrade", "")).startswith("over_budget"):
        fail(f"the over-budget family did not relax by sectors: {rec}")
    if relax_seen["peak_bytes_above_base"] > plan["predicted_peak_bytes"]:
        fail(f"the sector step outgrew its predicted peak: {rec}")
    if not valid_msa(smsa, big) or min(slaunch.values()) < 1:
        fail(f"the sector family's MSA or launches are wrong: {rec}")
    # several blocks on the card against the same call on the CPU
    sub_seqs = [degap(encode(q)) for _, q in big[:8]]
    sposts, _ = aligner.posterior_stage(sub_seqs, "mix", 0.17, dev)
    slens = [len(q) for q in sub_seqs]
    sbudget = aligner.sectorlib._sector_peak_bytes(4, 8, 512, 24)
    kw = {"reps": 2, "budget": sbudget}
    cplan: dict = {}
    on_card = aligner.sectorlib.relax_sector_device(
        sposts, slens, device="cuda", report=cplan, **kw)
    on_cpu = aligner.sectorlib.relax_sector_device(
        sposts, slens, device="cpu", **kw)
    err, edge = 0.0, 0.0
    for key in on_cpu:
        a_, b_ = on_card[key].toarray(), on_cpu[key].toarray()
        both = (a_ > 0) == (b_ > 0)
        err = max(err, float(abs(a_ - b_)[both].max(initial=0.0)))
        edge = max(edge, float(abs((a_ + b_)[~both] - 0.01).max(
            initial=0.0)))
    rec = {"n": 8, "lp": 512, "plan": cplan["sector"], "max_abs_err": err,
           "cutoff_edge_err": edge, "pairs": len(on_cpu)}
    print("[sector] card vs cpu: " + json.dumps(rec), flush=True)
    if cplan["sector"]["blocks"] < 2 or err > TOL["post"] \
            or edge > TOL["post"] or on_card.keys() != on_cpu.keys():
        fail(f"sector relaxation on the card disagrees with the CPU: {rec}")
    del sposts, on_card, on_cpu

    # ---- 11. [long]: past 8,192 lanes ---------------------------------------
    # The check runs at Lp = 8,192, the short instances' last length, and
    # at 8,320, the length the long family below takes: past the short
    # instances, so the sweep at 32 lanes a thread and combine's tiled DP,
    # in each mode the path runs.  The log2 totals get 2e-4 or 1e-6 of
    # |l2t|, whichever is larger (past |l2t| = 2,048 one f32 step is
    # 2.4e-4, and the two sum the local model in other orders).
    long_rec = {}
    models = MODEL_SETS["mix"]
    nm = len(models)
    tabs_f, tabs_r = pairwise._wf_tables("mix", 0.17, dev)

    def long_check(lp_chk):
        X, Y, LX, LY = batch(lp_chk, 1, seed=lp_chk)  # x full length
        fk, rk = sweeps(wk.sweep, X, Y, LX, LY, tabs_f, tabs_r, models)
        fp, rp = sweeps(wk.sweep_reference, X, Y, LX, LY, tabs_f, tabs_r,
                        models)
        e_plane = max(max(plane_err(fk, fp, m), plane_err(rk, rp, m))
                      for m in models)
        scale_rows = sum(int((k["scales"][m] != p["scales"][m]).sum())
                         for k, p in ((fk, fp), (rk, rp)) for m in models)
        l2t_pairs = [(float(k["log2t"][m][0]), float(p["log2t"][m][0]))
                     for k, p in ((fk, fp), (rk, rp)) for m in models]
        l2t_ok = all(abs(a_ - b_) <= max(TOL["l2t"], 1e-6 * abs(b_))
                     for a_, b_ in l2t_pairs)
        del fp, rp
        post_k, sc_k, nb_k = wk.combine(fk, rk, LX, LY, models,
                                        with_matches=True)
        post_p, sc_p, nb_p = wk.combine_reference(fk, rk, LX, LY, models,
                                                  with_matches=True)
        e_post = float((post_k - post_p).abs().max())
        outside = ~grid_mask(post_k.shape[0], post_k.shape[2], LX, LY)
        pad_nonzero = int((post_k[outside] != 0).sum())
        del post_p
        vals_w, lanes_w = wk.wf.topk_skew(post_k, 16, 0.01)
        topk_err, topk_lanes, topk_rest = 0.0, True, True
        for wm in (False, True):
            out = wk.combine(fk, rk, LX, LY, models, with_matches=wm,
                             topk=16, cutoff=0.01)
            topk_err = max(topk_err, float((out[0] - vals_w).abs().max()))
            topk_lanes &= bool(torch.equal(out[1][vals_w > 0],
                                           lanes_w[vals_w > 0]))
            topk_rest &= bool(torch.equal(out[2], sc_k))
            if wm:
                topk_rest &= bool(torch.equal(out[3], nb_k))
            del out
        chk = long_rec[f"check_lp{lp_chk}"] = {
            "plane_err": e_plane, "scale_rows_differing": scale_rows,
            "l2t_kernel_plain": l2t_pairs, "l2t_ok": l2t_ok,
            "post_err": e_post, "pad_nonzero": pad_nonzero,
            "score_ok": torch.allclose(sc_k, sc_p, rtol=TOL["score_rtol"],
                                       atol=TOL["score_atol"]),
            "matches_equal": bool(torch.equal(nb_k, nb_p)),
            "topk_err": topk_err, "topk_lanes_equal": topk_lanes,
            "topk_score_matches_equal": topk_rest}
        print("[long] " + json.dumps(chk), flush=True)
        if not (e_plane <= TOL["plane"] and scale_rows == 0 and l2t_ok
                and e_post <= TOL["post"] and pad_nonzero == 0
                and chk["score_ok"] and chk["matches_equal"]
                and topk_err <= TOL["topk"] and topk_lanes and topk_rest):
            fail(f"a kernel disagrees with its plain version at "
                 f"Lp={lp_chk}: {chk}")
        worst["sweep"] = max(worst["sweep"], e_plane)
        worst["combine"] = max(worst["combine"], e_post)
        del fk, rk, post_k, vals_w, lanes_w

    for lp_chk in (8192, 8320):
        long_check(lp_chk)
    # the kernels' times at B=1 beside their byte bounds
    long_times = {}
    for lp_ in (8192, 8320, 12288, 16384):
        X, Y, LX, LY = batch(lp_, 1, seed=lp_)
        z1 = torch.zeros((1,), dtype=torch.int32, device=dev)
        D_, W_ = 2 * lp_ + 1, lp_ + 1
        t_sw = cuda_ms(lambda: wk.sweep(X, Y, z1, z1, LX, LY, tabs_f,
                                        models=models), 3)
        fk, rk = sweeps(wk.sweep, X, Y, LX, LY, tabs_f, tabs_r, models)
        t_cm = cuda_ms(lambda: wk.combine(fk, rk, LX, LY, models,
                                          with_matches=True, topk=16), 3)
        t_cd = cuda_ms(lambda: wk.combine(fk, rk, LX, LY, models), 3)
        sw_b = bound(2 * lp_ + 16 + nm * (D_ * W_ + D_ + 1) * 4,
                     sum(SWEEP_OPS[m] for m in models) * D_ * W_)
        long_times[lp_] = {
            "sweep_ms": t_sw, "sweep_bound_ms": sw_b[0],
            "combine_topk16_matches_ms": t_cm, "combine_dense_ms": t_cd,
            "combine_dense_bound_ms":
                (2 * nm * (D_ * W_ + D_ + 1) * 4 + 8 + D_ * W_ * 4 + 4)
                / CARD_BYTES * 1e3}
        del fk, rk
    print("[long] mix B=1 times: " + json.dumps(long_times), flush=True)
    # cli base on a family with one sequence past 8,192 residues
    lfam = synthetic_family(3, 8250, 8250, sub=0.3, indel=0.05, seed=82)
    lfam = [lfam[0], (lfam[1][0], lfam[1][1][2000:3500]),
            (lfam[2][0], lfam[2][1][5000:6200])]
    lrep: dict = {}
    lmsa, lwall, llaunch, lpeak, ltimers = drive(
        lambda: aligner.align_family(lfam, config="pnp", report=lrep,
                                     device="cuda"))
    rec = {"family": "synthetic N=3 L=8250 sub=0.3 indel=0.05 seed=82, "
                     "two cut to 1,500 and 1,200 residues",
           "entry": "cli base (align_family config=pnp)",
           "wall_s": lwall, "stages_s": ltimers, "launches": llaunch,
           "report": lrep, "peak_device_bytes": lpeak,
           "valid": valid_msa(lmsa, lfam),
           "content_hash": lmsa.content_hash(), "columns": lmsa.length}
    print("[long] " + json.dumps(rec, default=float), flush=True)
    if not valid_msa(lmsa, lfam) or min(llaunch.values()) < 1:
        fail(f"the long family did not align on the card: {rec}")

    kernels = []
    for name, src, replaces in (
        ("sweep", "mlprobs_tpu_torch/ops/kernels/csrc/sweep.cu",
         "mlprobs_tpu/ops/pallas/wavefront_kernel.py:546"),
        ("combine", "mlprobs_tpu_torch/ops/kernels/csrc/combine.cu",
         "mlprobs_tpu/ops/pallas/wavefront_kernel.py:857"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": plaunch[name],
            "launches_by_path": {"base": launches[name],
                                 "pipeline": plaunch[name],
                                 "np": nlaunch[name],
                                 "sector": slaunch[name],
                                 "long": llaunch[name]},
            "max_abs_err": worst[name], "ms": timing[name][0],
            "plain_ms": timing[name][1], "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": None,
        })
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
