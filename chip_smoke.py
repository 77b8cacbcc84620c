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
    on the card must agree with the kernels' tensor.
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
        from mlprobs_tpu_torch.ops.kernels import build
        from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as wk
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
            vals_k, lanes_k, sc_t = wk.combine(fk, rk, LX, LY, models,
                                               topk=16, cutoff=0.01)
            vals_w, lanes_w = wk.wf.topk_skew(post_k, 16, 0.01)
            e_topk = float((vals_k - vals_w).abs().max())
            pos = vals_w > 0
            lanes_ok = bool(torch.equal(lanes_k[pos], lanes_w[pos]))
            rec = {"lp": lp, "b": b, "models": mode, "plane_err": e_plane,
                   "l2t_err": e_l2t, "scale_rows_differing": scale_rows,
                   "post_err": e_post, "pad_nonzero": pad_nonzero,
                   "score_ok": score_ok, "matches_equal": nb_ok,
                   "topk_err": e_topk, "topk_lanes_equal": lanes_ok,
                   "topk_score_equal": bool(torch.equal(sc_t, sc_k))}
            print("[check] " + json.dumps(rec), flush=True)
            # the sweep keeps the plain version's scales bit for bit
            ok = (e_plane <= TOL["plane"] and e_l2t <= TOL["l2t"]
                  and scale_rows == 0
                  and e_post <= TOL["post"] and pad_nonzero == 0
                  and score_ok and nb_ok and e_topk <= TOL["topk"]
                  and lanes_ok and rec["topk_score_equal"])
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

    kernels = []
    for name, src, replaces in (
        ("sweep", "mlprobs_tpu_torch/ops/kernels/csrc/sweep.cu",
         "mlprobs_tpu/ops/pallas/wavefront_kernel.py:546"),
        ("combine", "mlprobs_tpu_torch/ops/kernels/csrc/combine.cu",
         "mlprobs_tpu/ops/pallas/wavefront_kernel.py:857"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
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
