"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only multichip   # the build and phase 17 alone

Every phase runs unsharded (MLPROBS_MULTICHIP=0) but [multichip], which
sets its meshes itself.  Phases (any failure exits non-zero):
 1. device: the card's name and power limit, torch and CUDA versions;
 2. build: the four kernels from the repository's .cu sources, one nvcc
    each, in parallel, then the host library (utils/host.py) with g++,
    each build's seconds;
 3. kernels against their plain PyTorch versions on the card, for every
    model set, at Lp=512/B=64 and Lp=128/B=3: sweep planes, scales and
    totals; dense combine; the fused top-k against `topk_skew` of the
    kernel's own dense plane; MWT match counts.  The sweep's scales must
    equal the plain version's in every row.  The feature pass's Viterbi
    kernel and the qpx forward/backward kernels at Lp=128/B=8 and at the
    main shape, ragged lengths: every returned tensor equal to the plain
    version's bit for bit.  Then each kernel's time at the main path's
    shapes beside its plain version's and its bound (combine in each
    mode: dense, with match counts, top-k 16, and dense again at the
    family's last batch size; the Viterbi kernel's share of its bound
    too), and the sweep's time for each single-model set;
 4. the main path: a seeded twilight-zone family (N=48, 330-470
    residues) through `align_family(config="pnp")` on the card, with
    the kernels' launch counts, per-stage wall clock and peak memory;
    then one torch.profiler window around the family's posterior tensor
    (the five device operations with the most time, the device's idle
    share), and the consistency tensor rebuilt with the plain versions
    on the card must agree with the kernels' tensor; then [relax]: one
    relaxation of that tensor (N=48) and of its first 8 and 4 sequences,
    baseMSA's and weighted with the last cutoff at 1e-5, on the packed
    path (`relax_packed_rounds`, the main path's) against the dense
    einsum (`relax_dense_rounds`, the yardstick, `library_ms`): times,
    `gemm_flops` against the dense product's, peak bytes over the
    tensor, and the relaxed pair planes equal within 1e-6 but for
    entries kept by one side only, which sit within 1e-5 of a cutoff;
 5. [qp]: the realigner's qp posterior (`_qpx_combined_skew`: the qpx
    kernel's hmm5 posterior, the partition half through the sweep
    kernel) on the card against the CPU plain version at Lp=128/B=8
    (hmm5 half bit-equal, the whole atol 2e-4); then at the smoke
    family's qp shape (Lp=512, its batch size) the times of the qpx
    kernel and of its plain version, of the two partition sweeps and
    of the whole qp batch, its peak bytes against the batch budget of 80
    bytes per (pair, cell), and one profiler window around the kernel;
    then the qp route's MWT and top-k on that plane (`mwt_topk`,
    combine's GIVEN kind; top-k 16, with match counts, dense) against
    the plain `topk_skew` + `mwt_skew`, equal bit for bit (lanes where
    the value is positive), with both times and the kernel's bound;
 6. [pipeline]: `run_pipeline` (the `cli align` path) on the smoke family
    on the card: decisions, stage marks, launches (and the realigner's
    own), hash, peak bytes; no crash fallback, no block error, rows
    degap to the inputs; `mwt_topk` once per qp batch (as many calls as
    qpx launches);
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
11. [determinism]: the host profile-posterior scatter in processes of
    1 thread and of all the machine's threads, three calls each, bit-equal
    to the JAX package's numpy order (np.bincount in pair order); then the
    sector family of phase 10 once more in this process, from that
    run's feature statistics (the one stage not repeated): equal hashes
    (if not, each stage of its path runs twice to name the one that
    varies, and the run fails at its end, after the later phases);
12. [long]: sweep and combine at B=1, Lp=8,320 (the long family's
    length: the sweep's long instance, a cluster of 9 blocks, and
    combine's cluster of 13) against their plain versions, the Viterbi
    kernel at B=2 there bit for bit (65 strips of 128 lanes in five
    rounds of 13 warps) with its time and bound, and the three kernels'
    times at B=1 at Lp=8,192 (the sweep's short instance), 8,320 and
    16,384 and at B=2 at 8,320, each beside its bound, its share of it
    and the launch plan; then `cli base` on a three-sequence family with
    one sequence of 8,250 residues (every pair past 8,192 lanes or beside
    it): wall time, stage timers, validity, launches, and its MSA's hash,
    which must be the one recorded (EXPECTED_HASHES["long"]);
13. [qp-scaled]: MLPROBS_QP_EXACT=0, mode "qp" on both kernels with two
    models and the Vtml200 partition tables: the kernels against their
    plain versions at Lp=512/B=256 (dense, top-k, top-k with match
    counts), their times beside the qpx route's for the same batch;
    `run_pipeline` on the smoke family on the card (hash beside the
    default route's) and the small family on the card and the CPU (equal
    hashes);
14. [scan]: the row-scan posteriors (ops/pairhmm.py, ops/partition.py)
    of 4 smoke-family pairs on the card against combine's dense mix
    posterior, rtol 2e-3 / atol 2e-5;
15. [bench]: `cli bench` in a subprocess on a suite of two families
    (seeds 48 and 49) whose golden MSA for seed 48 is phase 6's: that
    family must score sp = tc = 1.000;
16. [annot]: `cli base --config quickprobs --annot --clustalw
    --autosave 1` in a subprocess on the smoke family: one score in
    0-200 per column, the ClustalW file equal to the last autosave;
17. [multichip]: the sharded pair stages on a pairs mesh of the card
    twice and, on a machine with two or more cards, on up to four of
    them (what MLPROBS_MULTICHIP=1 gives there), set in place of
    `pairwise._mesh`: each card's kernels against their plain versions
    (the Viterbi and qpx kernels bit for bit),
    `base` on the smoke family and `run_pipeline` on the small family
    through the production routes beside the same runs unsharded in the
    phase (hashes, which must be [main]'s and [pipeline-cpu]'s, wall
    clock, stages, peak bytes a device, launches), the sharded posterior
    step and dense tensor against the unsharded route (equal), and one
    sharded relaxation round against `relax_dense_rounds` (atol 1e-6);
18. [em]: one EM re-estimation (`ops/em.py`, with emissions) from two
    smoke-family sequences on the card against the CPU (rtol 1e-4,
    atol 1e-6);
19. [library]: `local_posterior_qpx` at Lp=512/B=32 on the card against
    the CPU (atol 2e-5, rtol 1e-3), and `column_scores_torch` of the smoke
    family's MSA on the card against the host scores (atol 1e-6).
Each path is driven with the launch counts of the four kernels set to 0
just before it and read just after (a subprocess reports its own); a
path that did not launch every kernel it runs fails: the feature pass
runs the Viterbi kernel, a qp batch the qpx kernel and combine.  No path
may call the plain `mwt_skew` or `topk_skew` on a card tensor: each
path counts those calls (a subprocess too) and fails on any.  Every
path's MSA keeps its recorded hash (EXPECTED_HASHES), [pipeline-cpu] the
same hash on the card and the CPU: a change fails the run at its end.
[timing] prints the qpx kernel's time beside QPX_PARENT_MS, the time
PERF.md records for the kernel before its redesign (a recorded constant,
not measured in the run); `ops/kernels/time_ab.py` times two checkouts
in one call.
Before the last line come the kernels' JSON record and the nvidia-smi
line; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

CARD_F32_OPS = 67e12        # H100 SXM f32 (non-tensor) peak, op/s
CARD_BYTES = 3.35e12        # H100 SXM HBM3 bandwidth, bytes/s
# f32 adds, multiplies, max/min and square roots per DP cell, counted
# from the kernels (selects and integer index arithmetic not counted):
# csrc/sweep.cu per model (recurrences, block max, rescale, emit and the
# neighbour sums); csrc/combine.cu per model (split multiply, clamp,
# square-accumulate) and per cell (RMS and the MWT step)
SWEEP_OPS = {"hmm5": 46, "local": 25, "partition": 17}
COMBINE_OPS_PER_MODEL, COMBINE_OPS_CELL = 6, 8
# csrc/viterbi.cu: 10 adds and 4 maxes a cell (the traceback's steps, a
# few thousand a pair, not counted); csrc/qpx.cu: 98 a cell and
# direction, each LOG_ADD counted as max, min, subtract, the cubic's 3
# multiplies and 3 adds, and the add of lo
VITERBI_OPS_CELL = 14
QPX_OPS_CELL = 2 * 98
KERNELS = ("sweep", "combine", "viterbi", "qpx")
# combine's GIVEN kind (the qp route's MWT and top-k): the MWT step's
# add and three compares a cell
GIVEN_OPS_CELL = 4
# the qpx kernel before its redesign (two launches, forward then
# backward) at the main shape, as PERF.md records it ([timing], NVIDIA
# H100 80GB HBM3, 700.00 W): a recorded constant, printed as such
QPX_PARENT_MS = 6.381
# every path's MSA as PERF.md records it: a change of the kernels'
# arithmetic that reaches an alignment shows here
EXPECTED_HASHES = {"main": "fd5a49930ffd7ec7", "pipeline": "8bdc5361a51c4197",
                   "np": "d49567685c2f8c21", "sector": "411a28b6fc0ff0cb",
                   "qp_scaled": "feeec500eb94c85c", "long": "8fc72362027e251b"}
# the kernels each path runs: the pnp base (feature pass, posteriors),
# the realigner (qpx hmm5 half, partition sweeps, MWT and top-k), both
BASE_KERNELS = ("sweep", "combine", "viterbi")
REALIGN_KERNELS = ("sweep", "combine", "qpx")
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


ROOT = Path(__file__).resolve().parent
# the sector family's hashes in three earlier card runs, before the host
# scatter summed in one order
SECTOR_HASHES_BEFORE = ("57501cc5c61c46df", "e4bfdc9515cd074b",
                        "4998f5afa2dd21ba")
# `python -m mlprobs_tpu_torch.pipeline.cli ...` that also reports the
# kernels' launches of its process, and its calls of the plain MWT and
# top-k on a card tensor (PlainTailCalls), on its last line
CLI_WITH_LAUNCHES = (
    "import json, runpy\n"
    "from chip_smoke import PlainTailCalls, launch_counts\n"
    "with PlainTailCalls() as plain:\n"
    "    try:\n"
    "        runpy.run_module('mlprobs_tpu_torch.pipeline.cli',\n"
    "                         run_name='__main__', alter_sys=True)\n"
    "    finally:\n"
    "        print('LAUNCHES ' + json.dumps(\n"
    "            {**launch_counts(), 'plain_tail_on_card': plain}),\n"
    "            flush=True)\n"
)


def launch_counts() -> dict:
    """{kernel: launches since the last reset_launch_counts()}."""
    from mlprobs_tpu_torch.ops.kernels import qpx_kernel as qk
    from mlprobs_tpu_torch.ops.kernels import viterbi_kernel as vk
    from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as wk

    return {"sweep": wk.sweep.launches, "combine": wk.combine.launches,
            "viterbi": vk.viterbi_stats.launches,
            "qpx": qk.hmm5_fb.launches}


def unlaunched(launched: dict, names) -> list:
    """The kernels of `names` that `launched` counts no launch of."""
    return [n for n in names if launched.get(n, 0) < 1]


class PlainTailCalls:
    """While active, counts the calls of the plain `mwt_skew` and
    `topk_skew` (ops/wavefront.py) on a card tensor: no path may make one,
    since the qp route's MWT and top-k run on the combine kernel."""

    NAMES = ("mwt_skew", "topk_skew")

    def __enter__(self):
        from mlprobs_tpu_torch.ops import wavefront

        self.mod, self.seen = wavefront, dict.fromkeys(self.NAMES, 0)
        self.real = {n: getattr(wavefront, n) for n in self.NAMES}
        for n, real in self.real.items():
            setattr(wavefront, n, self._counted(n, real))
        return self.seen

    def _counted(self, name, real):
        def fn(p, *a, **kw):
            self.seen[name] += p.device.type == "cuda"
            return real(p, *a, **kw)
        return fn

    def __exit__(self, *exc):
        for n, real in self.real.items():
            setattr(self.mod, n, real)
        return False
# host.profile_posterior of one process at its OpenMP thread count,
# three calls on the same input (an .npz written by scatter_input)
SCATTER_RUN = (
    "import sys, numpy as np\n"
    "from mlprobs_tpu_torch.utils import host\n"
    "z = np.load(sys.argv[1])\n"
    "keys = ('pair_start', 'pair_len', 'a_idx', 'b_idx', 'wts', 'coo_r',\n"
    "        'coo_c', 'coo_v', 'maps1', 'map1_off', 'maps2', 'map2_off')\n"
    "out = [host.profile_posterior(int(z['l1']), int(z['l2']),\n"
    "                              *(z[k] for k in keys),\n"
    "                              float(z['cutoff_sub']))\n"
    "       for _ in range(3)]\n"
    "np.save(sys.argv[2], np.stack(out))\n"
)


def run_cli(args, dev_args=(), timeout=900):
    """(stdout lines, launches, wall s) of the port's CLI in a subprocess
    from the checkout's root; a non-zero exit fails the run."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", CLI_WITH_LAUNCHES, *args, *dev_args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0:
        fail(f"cli {' '.join(args[:1])} exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    launches = json.loads(lines[-1].split(" ", 1)[1])
    plain = launches.pop("plain_tail_on_card")
    if any(plain.values()):
        fail(f"cli {' '.join(args[:1])} ran the plain MWT or top-k on the "
             f"card: {plain}")
    return lines[:-1], launches, wall


def scatter_input(seed=0):
    """One seeded input of the host scatter at a merge's scale: 48 x 48
    pairs of 4,000 entries (sorted by row) into a 600 x 600 profile
    plane, ClustalW-like weights and the realigner's cutoff."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n1 = n2 = 48
    l1 = l2 = 600
    maps = []
    for _ in range(n1 + n2):
        maps.append(np.sort(rng.choice(600, 470, replace=False))
                    .astype(np.int32))
    r, c, v, start, length = [], [], [], [], []
    off = 0
    for _ in range(n1 * n2):
        cells = np.sort(rng.choice(470 * 470, 4000, replace=False))
        r.append((cells // 470).astype(np.int32))
        c.append((cells % 470).astype(np.int32))
        v.append((0.01 + 0.99 * rng.random(4000)).astype(np.float32))
        start.append(off)
        length.append(4000)
        off += 4000
    moff = np.arange(0, 470 * (n1 + 1), 470, dtype=np.int64)
    return {
        "l1": l1, "l2": l2, "cutoff_sub": 0.01,
        "pair_start": np.array(start, np.int64),
        "pair_len": np.array(length, np.int64),
        "a_idx": np.repeat(np.arange(n1, dtype=np.int32), n2),
        "b_idx": np.tile(np.arange(n2, dtype=np.int32), n1),
        "wts": rng.random(n1 * n2) / (n1 * n2),
        "coo_r": np.concatenate(r), "coo_c": np.concatenate(c),
        "coo_v": np.concatenate(v),
        "maps1": np.concatenate(maps[:n1]), "map1_off": moff,
        "maps2": np.concatenate(maps[n1:]), "map2_off": moff,
    }


def scatter_reference(z):
    """The JAX package's numpy scatter on the same input: each entry
    adds the f32 product w * v, np.bincount sums in pair order in double,
    the cutoff subtraction sums in a second double plane added after, one
    cast to f32."""
    import numpy as np

    l1, l2 = z["l1"], z["l2"]
    idx, val = [], []
    sub = np.zeros((l1, l2))
    for p in range(len(z["pair_start"])):
        a, b = z["a_idx"][p], z["b_idx"][p]
        m1 = z["maps1"][z["map1_off"][a]:z["map1_off"][a + 1]]
        m2 = z["maps2"][z["map2_off"][b]:z["map2_off"][b + 1]]
        e = slice(z["pair_start"][p], z["pair_start"][p] + z["pair_len"][p])
        w = float(z["wts"][p])
        idx.append(m1[z["coo_r"][e]].astype(np.int64) * l2
                   + m2[z["coo_c"][e]])
        val.append(w * z["coo_v"][e])
        sub[np.ix_(m1, m2[:-1])] -= w * z["cutoff_sub"]
    out = np.bincount(np.concatenate(idx), weights=np.concatenate(val),
                      minlength=l1 * l2).reshape(l1, l2)
    return (out + sub).astype(np.float32)


def feature_kernels_equal(X, Y, LX, LY) -> dict:
    """{output: equal bit for bit} of the Viterbi kernel and the qpx
    kernels against their plain versions on one card batch (the qpx
    posterior pass over each side's planes included)."""
    import torch
    from mlprobs_tpu_torch.align import pairwise
    from mlprobs_tpu_torch.ops import qpx
    from mlprobs_tpu_torch.ops.kernels import qpx_kernel as qk
    from mlprobs_tpu_torch.ops.kernels import viterbi_kernel as vk

    tabs = pairwise.viterbi_tables(pairwise.mp.blosum62(), X.device)
    out = {}
    for n, a, b in zip(
            ("dirs", "end_state", "score", "pathlen", "matches",
             "scores_rev"), vk.viterbi_stats(X, Y, LX, LY, *tabs),
            vk.viterbi_reference(X, Y, LX, LY, *tabs)):
        out["viterbi." + n] = bool(torch.equal(a, b))
    p5 = pairwise._qpx_params(X.device)
    k = qk.hmm5_fb(X, Y, LX, LY, *p5)
    p = qpx.hmm5_fb_qpx(X, Y, LX, LY, *p5)
    for n, a, b in zip(("fwd_m", "bwd_m", "total"), k, p):
        out["qpx." + n] = bool(torch.equal(a, b))
    out["qpx.posterior"] = bool(torch.equal(
        qpx.posterior_from_fb(*k, LX, LY), qpx.posterior_from_fb(*p, LX, LY)))
    return out


def phase_relax(tensor, records, deferred):
    """[relax]: one relaxation (two rounds) of the smoke family's tensor
    and of its first 8 and 4 sequences, unweighted and weighted (last
    cutoff 1e-5), on the packed path against the dense einsum: both
    times (CUDA events, median of 3 after one warm-up), `gemm_flops`,
    peak bytes over the tensor's, and the pair planes compared; then the
    base aligner's wall seconds on the first 8 and 4 sequences (5 runs
    each, median and quartiles), the spread that a relaxation's time
    difference at that size is set against."""
    import numpy as np
    import torch

    from mlprobs_tpu_torch.align import aligner
    from mlprobs_tpu_torch.align import consistency as cons
    from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return statistics.median(ms), torch.cuda.max_memory_allocated() - base

    for n in (48, 8, 4):
        S = tensor.S[:n, :n].contiguous()
        lens = tensor.seq_lens[:n]
        lp = S.shape[-1]
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        ii = torch.tensor([i for i, _ in pairs], device=S.device)
        jj = torch.tensor([j for _, j in pairs], device=S.device)
        pk = cons.Packing(lens, pairs, lp, S.device)
        for weighted in (False, True):
            w = (np.random.default_rng(n).random(n) + 0.5 if weighted
                 else None)
            final = 1e-5 if weighted else None
            sc, zs, ww = cons.dense_relax_coeffs(n, w)
            dense_args = [torch.from_numpy(a).to(S.device)
                          for a in (sc, zs, ww)]

            def dense():
                return cons.relax_dense_rounds(
                    S, *dense_args, reps=2, final_cutoff=final)[ii, jj]

            def packed():
                R = cons.relax_packed_rounds(pk.pack(S), pk, sc, zs, ww,
                                             reps=2, final_cutoff=final)
                return pk.unpack(R)

            library_ms, library_peak = timed(dense)
            STATS.reset()
            packed_ms, packed_peak = timed(packed)
            flops = STATS.counters["gemm_flops"] // 4
            got, want = packed(), dense()
            both = (got > 0) == (want > 0)
            err = float((got - want)[both].abs().max())
            one = (got + want)[~both]
            cuts = [cons.CUTOFF] + ([final] if final else [])
            off_cut = one.numel() and float(torch.stack(
                [(one - c).abs() for c in cuts]).min(0).values.max())
            rec = {"n": n, "weighted": weighted, "side": pk.side,
                   "packed_ms": packed_ms, "library_ms": library_ms,
                   "gemm_flops": flops,
                   "dense_flops": 2 * (n * lp) ** 3 * 2,
                   "packed_peak_bytes": packed_peak,
                   "library_peak_bytes": library_peak,
                   "max_abs_err": err, "one_side_cells": int(one.numel()),
                   "one_side_from_cutoff": off_cut}
            print("[relax] " + json.dumps(rec), flush=True)
            if err > 1e-6 or off_cut > 1e-5:
                deferred.append(f"[relax] packed against dense: {rec}")
            del got, want, both, one
        del S
        if n < 48:
            walls = []
            for _ in range(6):
                t0 = time.perf_counter()
                aligner.align_family(records[:n], config="pnp",
                                     device="cuda")
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            q = statistics.quantiles(walls[1:], n=4)
            rec = {"n": n, "family_s_median": statistics.median(walls[1:]),
                   "family_s_quartiles": [q[0], q[2]], "runs": walls[1:]}
            print("[relax] base aligner " + json.dumps(rec), flush=True)


def phase_determinism_host(work):
    """[determinism]: host.profile_posterior at 1 thread and at all of
    the machine's threads, three calls each, against the numpy order."""
    import numpy as np

    z = scatter_input()
    np.savez(work / "scatter.npz", **z)
    want = scatter_reference(z)
    # the threads this process may run on (`nproc`), and the host's count
    nproc = len(os.sched_getaffinity(0))
    rec = {"nproc": nproc, "cpu_count": os.cpu_count(),
           "plane": [z["l1"], z["l2"]],
           "pairs": len(z["pair_start"]), "entries": len(z["coo_v"])}
    for threads in sorted({1, nproc}):
        dst = work / f"scatter_{threads}.npy"
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", SCATTER_RUN,
                        str(work / "scatter.npz"), str(dst)],
                       cwd=ROOT, env=env, check=True, timeout=600)
        got = np.load(dst)
        rec[f"threads_{threads}"] = {
            "process_s": time.perf_counter() - t0,
            "calls_bit_equal": bool(all(np.array_equal(g, got[0])
                                        for g in got)),
            "cells_differing_from_numpy": int((got != want).sum()),
        }
    print("[determinism] host scatter: " + json.dumps(rec), flush=True)
    if not all(v["calls_bit_equal"] and v["cells_differing_from_numpy"] == 0
               for k, v in rec.items() if k.startswith("threads_")):
        fail(f"the host scatter depends on its threads: {rec}")


def phase_sector_repeat(big, first_hash, stats, drive, deferred):
    """[determinism]: the sector family through `align_family` a second
    time in this process, from the [sector] phase's feature statistics
    (the feature pass is the one stage it does not repeat); its hash
    against the [sector] phase's.  If they differ, each stage of the path
    runs twice on the same inputs to name the one whose output varies
    (recorded; the run fails at its end)."""
    import numpy as np
    from mlprobs_tpu_torch.align import aligner, progressive
    from mlprobs_tpu_torch.align import tree as treelib
    from mlprobs_tpu_torch.core.alphabet import degap, encode
    from mlprobs_tpu_torch.core.msa import MSA
    from mlprobs_tpu_torch.utils.crand import GlibcRand

    rep: dict = {}
    msa, wall, launched, _, timers = drive(
        lambda: aligner.align_family(big, config="pnp", stats=stats,
                                     report=rep, device="cuda"))
    rec = {"first_hash": first_hash, "second_hash": msa.content_hash(),
           "hashes_before": SECTOR_HASHES_BEFORE, "wall_s": wall,
           "stages_s": timers, "launches": launched,
           "engine": rep.get("consistency_engine")}
    rec["equal"] = rec["first_hash"] == rec["second_hash"]
    if not rec["equal"]:
        # bisect: posteriors, sector relaxation and merge, twice each
        seqs = [degap(encode(q)) for _, q in big]
        stats = aligner.family_viterbi_stats(seqs, device="cuda")
        leave = aligner.mp.adaptive_leave_prob(stats.avg_pid)
        lens = [len(q) for q in seqs]
        runs = [aligner.posterior_stage(seqs, "mix", leave, "cuda")
                for _ in range(2)]
        same = {"posteriors": all(
            (runs[0][0][k] != runs[1][0][k]).nnz == 0 for k in runs[0][0])
            and np.array_equal(runs[0][1], runs[1][1])}
        posts, dist = runs[0]
        relaxed = [aligner.sectorlib.relax_sector_device(
            posts, lens, device="cuda", reps=2) for _ in range(2)]
        same["sector_relaxation"] = all(
            (relaxed[0][k] != relaxed[1][k]).nnz == 0 for k in relaxed[0])
        root = treelib.upgma(dist, variance_id=stats.variance_bit)
        merged = [progressive.compute_final_alignment(
            root, MSA.from_unaligned(big), relaxed[0],
            pid=stats.pid_class, rng=GlibcRand(1), base_reps=100)
            .content_hash() for _ in range(2)]
        same["merge"] = merged[0] == merged[1]
        rec["stage_outputs_equal_over_two_runs"] = same
        deferred.append(f"the sector family's hash varies: {rec}")
    print("[determinism] sector family twice: "
          + json.dumps(rec, default=float), flush=True)
    return launched


def phase_qp_scaled(dev, batch, cuda_ms, records, default_hash, small,
                    drive, valid_msa, tol):
    """[qp-scaled]: MLPROBS_QP_EXACT=0, mode "qp" on both kernels with two
    models (hmm5 + the Vtml200 partition): the kernels against their
    plain versions at Lp = 512, B = 256 (dense, top-k, top-k with match
    counts) and their times beside the qpx route's for the same batch;
    then `run_pipeline` on the smoke family on the card, and the small
    family on the card and the CPU."""
    import torch
    from mlprobs_tpu_torch.align import pairwise
    from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as wk
    from mlprobs_tpu_torch.pipeline.driver import run_pipeline

    models = ("hmm5", "partition")
    lp, b = 512, 256
    tabs_f, tabs_r = pairwise._wf_tables("qp", None, dev)
    X, Y, LX, LY = batch(lp, b, seed=21)
    zero = torch.zeros((b,), dtype=torch.int32, device=dev)
    flipped = (X.flip(1).contiguous(), Y.flip(1).contiguous(),
               (lp - LX).to(torch.int32), (lp - LY).to(torch.int32))
    fk = wk.sweep(X, Y, zero, zero, LX, LY, tabs_f, models=models)
    rk = wk.sweep(*flipped, LX, LY, tabs_r, models=models, emit_pre=True)
    fp = wk.sweep_reference(X, Y, zero, zero, LX, LY, tabs_f, models=models)
    rp = wk.sweep_reference(*flipped, LX, LY, tabs_r, models=models,
                            emit_pre=True)
    chk = {"lp": lp, "b": b, "models": list(models), "tables": "qp"}
    chk["scale_rows_differing"] = sum(
        int((k["scales"][m] != q["scales"][m]).sum())
        for k, q in ((fk, fp), (rk, rp)) for m in models)
    chk["plane_err"] = max(
        float(((k["planes"][m] - q["planes"][m]).abs().amax(dim=2)
               / q["planes"][m].abs().amax(dim=2).clamp(min=1e-38)).max())
        for k, q in ((fk, fp), (rk, rp)) for m in models)
    chk["l2t_err"] = max(float((k["log2t"][m] - q["log2t"][m]).abs().max())
                         for k, q in ((fk, fp), (rk, rp)) for m in models)
    del fp, rp
    post, sc, nb = wk.combine(fk, rk, LX, LY, models, with_matches=True)
    post_p, sc_p, nb_p = wk.combine_reference(fk, rk, LX, LY, models,
                                              with_matches=True)
    chk["post_err"] = float((post - post_p).abs().max())
    chk["score_ok"] = torch.allclose(sc, sc_p, rtol=tol["score_rtol"],
                                     atol=tol["score_atol"])
    chk["matches_equal"] = bool(torch.equal(nb, nb_p))
    del post_p
    vw, lw = wk.wf.topk_skew(post, 16, 0.01)
    chk["topk_err"], chk["topk_lanes_equal"] = 0.0, True
    chk["topk_score_matches_equal"] = True
    for wm in (False, True):
        out = wk.combine(fk, rk, LX, LY, models, with_matches=wm, topk=16,
                         cutoff=0.01)
        chk["topk_err"] = max(chk["topk_err"],
                              float((out[0] - vw).abs().max()))
        chk["topk_lanes_equal"] &= bool(torch.equal(out[1][vw > 0],
                                                    lw[vw > 0]))
        chk["topk_score_matches_equal"] &= bool(torch.equal(out[2], sc))
        if wm:
            chk["topk_score_matches_equal"] &= bool(torch.equal(out[3], nb))
    print("[qp-scaled] check: " + json.dumps(chk), flush=True)
    if not (chk["scale_rows_differing"] == 0
            and chk["plane_err"] <= tol["plane"]
            and chk["l2t_err"] <= tol["l2t"]
            and chk["post_err"] <= tol["post"] and chk["score_ok"]
            and chk["matches_equal"] and chk["topk_err"] <= tol["topk"]
            and chk["topk_lanes_equal"] and chk["topk_score_matches_equal"]):
        fail(f"a kernel disagrees with its plain version on the qp "
             f"tables: {chk}")
    del fk, rk, post, vw, lw
    scaled = pairwise._wf_fn(models, False, lambda d: (tabs_f, tabs_r))
    exact = pairwise._qp_exact_fn(False, lambda d: (tabs_f, tabs_r))
    times = {
        "sweep_fwd_ms": cuda_ms(lambda: wk.sweep(
            X, Y, zero, zero, LX, LY, tabs_f, models=models), 7),
        "sweep_rev_ms": cuda_ms(lambda: wk.sweep(
            *flipped, LX, LY, tabs_r, models=models, emit_pre=True), 7),
        "scaled_batch_ms": cuda_ms(lambda: scaled(X, Y, LX, LY), 7),
        "qpx_batch_ms": cuda_ms(lambda: exact(X, Y, LX, LY), 1,
                                warm=False),
    }
    fk, rk = (wk.sweep(X, Y, zero, zero, LX, LY, tabs_f, models=models),
              wk.sweep(*flipped, LX, LY, tabs_r, models=models,
                       emit_pre=True))
    times["combine_dense_ms"] = cuda_ms(
        lambda: wk.combine(fk, rk, LX, LY, models), 7)
    times["combine_topk16_ms"] = cuda_ms(
        lambda: wk.combine(fk, rk, LX, LY, models, topk=16), 7)
    times["combine_topk16_matches_ms"] = cuda_ms(
        lambda: wk.combine(fk, rk, LX, LY, models, with_matches=True,
                           topk=16), 7)
    del fk, rk
    print(f"[qp-scaled] timing Lp={lp} B={b}: " + json.dumps(times),
          flush=True)

    old = os.environ.get("MLPROBS_QP_EXACT")
    os.environ["MLPROBS_QP_EXACT"] = "0"
    try:
        (msa, rep), wall, launched, peak, timers = drive(
            lambda: run_pipeline(records, device="cuda"))
        (smsa, srep), swall, slaunch, _, _ = drive(
            lambda: run_pipeline(small, device="cuda"))
        t0 = time.perf_counter()
        hmsa, hrep = run_pipeline(small, device="cpu")
        hwall = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("MLPROBS_QP_EXACT", None)
        else:
            os.environ["MLPROBS_QP_EXACT"] = old
    rec = {"family": "synthetic N=48 L=330-470 sub=0.5 indel=0.1 seed=48",
           "entry": "cli align (run_pipeline), MLPROBS_QP_EXACT=0",
           "wall_s": wall, "marks_s": rep.timings, "stage_timers_s": timers,
           "launches": launched, "peak_device_bytes": peak,
           "engines": rep.engines, "whole_family_realign":
               rep.whole_family_realign,
           "valid": valid_msa(msa, records), "hash": rep.final_hash,
           "default_route_hash": default_hash,
           "block_errors": rep.block_errors, "error": rep.error}
    print("[qp-scaled] pipeline: " + json.dumps(rec, default=float),
          flush=True)
    srec = {"family": "synthetic N=6 L=40-90 sub=0.2 indel=0.05 seed=5",
            "cuda": {"wall_s": swall, "hash": srep.final_hash,
                     "launches": slaunch},
            "cpu": {"wall_s": hwall, "hash": hrep.final_hash},
            "hashes_equal": srep.final_hash == hrep.final_hash}
    print("[qp-scaled] small family: " + json.dumps(srec), flush=True)
    if (not rec["valid"] or rep.crash_fallback or rep.block_errors
            or unlaunched(launched, BASE_KERNELS)):
        fail(f"the scaled qp route's pipeline failed on the card: {rec}")
    if not srec["hashes_equal"] or not valid_msa(smsa, small) \
            or srep.crash_fallback or srep.block_errors:
        fail(f"the scaled qp route differs on the card and the CPU: {srec}")
    return launched, times, rep.final_hash


def phase_scan(dev, seqs, leave, wk_posterior_dense):
    """[scan]: the row-scan posteriors (mix: hmm5, partition, local) of 4
    pairs of the smoke family on the card against the CUDA combine's
    dense posterior, at the JAX package's tolerance between the two
    formulations (rtol 2e-3, atol 2e-5)."""
    import torch
    from mlprobs_tpu_torch.align import pairwise

    pairs = [(0, 1), (2, 3), (4, 5), (6, 7)]
    lp = pairwise._bucket_len(max(len(seqs[k]) for p in pairs for k in p))
    (chunk, X, Y, LX, LY), = list(pairwise.iter_pair_batches(
        seqs, pairs, dev, force_lp=lp))
    # the scan engine's arithmetic: the scans in float64, then f32
    params = pairwise._scan_params("mix", leave, dev, torch.float64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    posts = [pairwise._SCAN_MODELS[m](X, Y, LX, LY, params[m]).float()
             for m in ("hmm5", "partition", "local")]
    scan = torch.sqrt(sum(p * p for p in posts) / 3)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    kern = wk_posterior_dense(X, Y, LX, LY, leave)
    err = (scan - kern).abs()
    excess = err - (2e-5 + 2e-3 * kern.abs())
    rec = {"pairs": pairs, "lp": lp, "lengths": [[int(a), int(b)]
           for a, b in zip(LX.tolist(), LY.tolist())],
           "max_abs_err": [float(e.max()) for e in err],
           "max_excess_over_tol": float(excess.max()),
           "row_scan_s": scan_s}
    print("[scan] row scans vs combine (mix): " + json.dumps(rec),
          flush=True)
    if rec["max_excess_over_tol"] > 0:
        fail(f"the row-scan posteriors disagree with combine: {rec}")
    return rec


def phase_bench(work, families, golden_msa, dev_args):
    """[bench]: `cli bench` in a subprocess on a suite this phase writes,
    scored against the [pipeline] phase's MSA of the first family."""
    from mlprobs_tpu_torch.core.fasta import write_fasta

    suite = work / "bench" / "TEST" / "synthetic"
    (suite / "in").mkdir(parents=True)
    golden = work / "bench" / "golden"
    golden.mkdir()
    for name, recs in families.items():
        write_fasta(suite / "in" / name, recs, width=0)
    first = next(iter(families))
    write_fasta(golden / first, golden_msa.to_records(), width=0)
    lines, launched, wall = run_cli(
        ["bench", str(suite), "--golden", str(golden), "--out",
         str(work / "bench" / "out")], dev_args, timeout=600)
    summary = json.loads(lines[-1])
    rec = {"suite": {k: "synthetic N=48 L=330-470 sub=0.5 indel=0.1 "
                     f"seed={k[-2:]}" for k in families},
           "lines": lines[:-1], "summary": summary, "wall_s": wall,
           "launches": launched}
    print("[bench] " + json.dumps(rec), flush=True)
    line = next((ln for ln in lines if ln.startswith(first + ":")), "")
    if "sp=1.000 tc=1.000" not in line or summary["families"] != 2 \
            or unlaunched(launched, KERNELS):
        fail(f"cli bench did not score the [pipeline] MSA as itself: {rec}")
    return launched


def parse_clustal(text):
    """{name: aligned row} of write_clustal's text."""
    rows: dict = {}
    for line in text.splitlines()[2:]:
        if line.strip():
            name, chunk = line.split()
            rows[name] = rows.get(name, "") + chunk
    return rows


def phase_annot(work, records, dev_args):
    """[annot]: `cli base --config quickprobs --annot --clustalw
    --autosave 1` on the smoke family (the realigner, whose refinement
    autosaves): one score in 0-200 per column, and a ClustalW file that
    parses back into the final MSA (the last autosave).  The realigner's
    qpx route runs the qpx kernels (its hmm5 half) and the sweep (its
    partition half), and they must have launched."""
    from mlprobs_tpu_torch.core.fasta import read_fasta, write_fasta

    inp, out = work / "annot_in.fa", work / "annot_out.aln"
    write_fasta(inp, records, width=0)
    _, launched, wall = run_cli(
        ["base", str(inp), str(out), "--config", "quickprobs", "--annot",
         str(work / "annot.txt"), "--clustalw", "--autosave", "1"],
        dev_args)
    rows = parse_clustal(out.read_text())
    scores = [int(v) for v in (work / "annot.txt").read_text().split()]
    saves = sorted(work.glob("annot_out.aln_r*"),
                   key=lambda q: int(q.name.rsplit("_r", 1)[1]))
    last = dict(read_fasta(saves[-1])) if saves else {}
    by_header = dict(records)
    rec = {"family": "synthetic N=48 L=330-470 sub=0.5 indel=0.1 seed=48",
           "wall_s": wall, "launches": launched, "columns":
               len(next(iter(rows.values()))) if rows else 0,
           "annot_lines": len(scores),
           "annot_range": [min(scores), max(scores)] if scores else None,
           "autosaves": len(saves),
           "clustal_equals_last_autosave": rows == last,
           "rows_degap_to_inputs": rows.keys() == by_header.keys() and all(
               r.replace("-", "") == by_header[h] for h, r in rows.items())}
    print("[annot] " + json.dumps(rec), flush=True)
    if not (rec["rows_degap_to_inputs"] and rec["clustal_equals_last_autosave"]
            and rec["annot_lines"] == rec["columns"] > 0
            and 0 <= rec["annot_range"][0] <= rec["annot_range"][1] <= 200
            and not unlaunched(launched, REALIGN_KERNELS)):
        fail(f"cli base --annot --clustalw --autosave failed: {rec}")
    return launched


def phase_multichip(dev, batch, records, small, seqs, leave, drive,
                    valid_msa, main_hash=None, small_hash=None):
    """[multichip]: the sharded routes on a pairs mesh of the card twice
    and, with two or more cards, on up to four of them, each set in
    place of `pairwise._mesh` (what MLPROBS_MULTICHIP=1 gives on a
    machine with several cards): `base` on the smoke family and
    `run_pipeline` on the small family through the production entry
    points, beside the same runs unsharded in this call (hashes, devices,
    wall clock, stages, peak bytes a device, launches); then the sharded
    posterior step and the dense tensor against the unsharded route, and
    one sharded relaxation round against `relax_dense_rounds` on the
    smoke family's tensor.  The unsharded hashes must equal
    `main_hash` and `small_hash` ([main]'s, [pipeline-cpu]'s) when they
    are given.  Returns the launches of the first mesh's `base` run."""
    import torch
    from mlprobs_tpu_torch.align import aligner, pairwise
    from mlprobs_tpu_torch.align import consistency as cons
    from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as wk
    from mlprobs_tpu_torch.parallel import sharded
    from mlprobs_tpu_torch.parallel.mesh import pairs_mesh
    from mlprobs_tpu_torch.pipeline.driver import run_pipeline

    n_cards = torch.cuda.device_count()
    meshes = [pairs_mesh([dev, dev])]
    if n_cards >= 2:
        meshes.append(pairs_mesh(
            [torch.device("cuda", k) for k in range(min(4, n_cards))]))
    real_mesh = pairwise._mesh
    if real_mesh(dev) is not None:
        fail("the unsharded reference runs have a mesh")

    def runs(devices):
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
        rep: dict = {}
        msa, wall, launched, _, timers = drive(
            lambda: aligner.align_family(records, config="pnp", strategy=0,
                                         report=rep, device="cuda"))
        peaks = {str(d): torch.cuda.max_memory_allocated(d)
                 for d in devices}
        (smsa, srep), swall, slaunch, _, _ = drive(
            lambda: run_pipeline(small, device="cuda"))
        rec = {"base": {"family": "synthetic N=48 L=330-470 sub=0.5 "
                                  "indel=0.1 seed=48",
                        "wall_s": wall, "stages_s": timers,
                        "launches": launched,
                        "peak_device_bytes": peaks, "report": rep,
                        "valid": valid_msa(msa, records),
                        "content_hash": msa.content_hash()},
               "pipeline_small": {"wall_s": swall, "launches": slaunch,
                                  "hash": srep.final_hash,
                                  "block_errors": srep.block_errors,
                                  "valid": valid_msa(smsa, small)}}
        ok = (rec["base"]["valid"] and rec["pipeline_small"]["valid"]
              and rep.get("consistency_engine") == "device"
              and not unlaunched(launched, BASE_KERNELS)
              and not unlaunched(slaunch, KERNELS)
              and not srep.crash_fallback and not srep.block_errors)
        return rec, ok, launched

    # the unsharded runs that the meshes are held against, in this call
    unsharded, ok, _ = runs([torch.device("cuda",
                                          torch.cuda.current_device())])
    print("[multichip] unsharded " + json.dumps(unsharded, default=float),
          flush=True)
    main_hash = main_hash or unsharded["base"]["content_hash"]
    small_hash = small_hash or unsharded["pipeline_small"]["hash"]
    if (not ok or unsharded["base"]["content_hash"] != main_hash
            or unsharded["pipeline_small"]["hash"] != small_hash):
        fail(f"the unsharded reference runs failed or moved: {unsharded}")
    X, Y, LX, LY = batch(512, 64, seed=64)
    tensor0 = pairwise.device_posterior_tensor(seqs, "mix", leave,
                                               device=dev)
    p0, s0 = sharded.make_sharded_posterior_step(pairs_mesh([dev]))(
        X, Y, LX, LY)
    first = None
    try:
        for mesh in meshes:
            pairwise._mesh = lambda device="cuda", mesh=mesh: mesh
            cards = sorted({d.index for d in mesh.devices})
            # each distinct card's kernels against their plain versions
            kernel_err, feature_equal = {}, {}
            mix = MODEL_SETS["mix"]
            for k in cards:
                d = torch.device(dev.type, k)
                x, y, lx, ly = (t[:3].to(d) for t in (X, Y, LX, LY))
                tfd, trd = pairwise._wf_tables("mix", 0.17, d)
                post_k, _ = wk.posterior(x, y, lx, ly, tfd, trd, models=mix)
                zero = torch.zeros_like(lx)
                fwd = wk.sweep_reference(x, y, zero, zero, lx, ly, tfd,
                                         models=mix)
                rev = wk.sweep_reference(
                    x.flip(1).contiguous(), y.flip(1).contiguous(),
                    (x.shape[1] - lx).to(torch.int32),
                    (x.shape[1] - ly).to(torch.int32),
                    lx, ly, trd, models=mix, emit_pre=True)
                post_p, _ = wk.combine_reference(fwd, rev, lx, ly, mix)
                kernel_err[str(d)] = float((post_k - post_p).abs().max())
                feature_equal[str(d)] = feature_kernels_equal(
                    *batch(128, 3, seed=k + 3, device=d))
            rec, ok, launched = runs(sorted(set(mesh.devices), key=str))
            # the stages against the unsharded route on the same inputs
            p1, s1 = sharded.make_sharded_posterior_step(mesh)(X, Y, LX, LY)
            tensor1 = pairwise.device_posterior_tensor(seqs, "mix", leave,
                                                       device=dev)
            S = tensor0.S
            n = S.shape[0]
            sc, zs, w = cons.dense_relax_coeffs(n)
            want = cons.relax_dense_rounds(
                S, *(torch.from_numpy(a).to(dev) for a in (sc, zs, w)),
                reps=1)
            got = pairwise._relax_sharded(S, sc, zs, w, 1, mesh)
            rec = {
                "mesh": [str(d) for d in mesh.devices],
                "cards": [torch.cuda.get_device_name(k) for k in cards],
                "kernel_vs_plain_err": kernel_err,
                "viterbi_qpx_bit_equal": feature_equal, **rec,
                "unsharded_hashes": [main_hash, small_hash],
                "posterior_step_err": float((p1 - p0).abs().max()),
                "posterior_step_score_err": float((s1 - s0).abs().max()),
                "tensor_equal": bool(torch.equal(tensor1.S, S)),
                "dist_equal": bool((tensor1.dist == tensor0.dist).all()),
                "relax_round_err": float((got - want).abs().max()),
                "relax_round_cells_differing": int((got != want).sum()),
            }
            print("[multichip] " + json.dumps(rec, default=float),
                  flush=True)
            del p1, tensor1, want, got
            if first is None:
                first = launched
            if (max(kernel_err.values()) > TOL["post"] or not ok
                    or not all(all(v.values())
                               for v in feature_equal.values())):
                fail(f"a sharded route failed: {rec}")
            if (rec["posterior_step_err"] > 0 or not rec["tensor_equal"]
                    or not rec["dist_equal"]
                    or rec["relax_round_err"] > 1e-6):
                fail(f"a sharded stage differs from the unsharded one "
                     f"beyond the relaxation's rounding: {rec}")
            if (rec["base"]["content_hash"] != main_hash
                    or rec["pipeline_small"]["hash"] != small_hash):
                # allowed only where the row-blocked contraction rounds
                # otherwise than the whole one (within 1e-6, above)
                if rec["relax_round_cells_differing"] == 0:
                    fail(f"a sharded route changed a family's MSA: {rec}")
                print("[multichip] hash differs from the unsharded run; "
                      "first differing stage: the relaxation "
                      f"({rec['relax_round_cells_differing']} cells, at "
                      f"most {rec['relax_round_err']:.3g})", flush=True)
    finally:
        pairwise._mesh = real_mesh
        pairwise._reset_engine_caches()
    return first


def phase_em(dev, seqs):
    """[em]: one EM re-estimation (`ops/em.hmm5_em_step`, with emissions)
    from the first two smoke-family sequences on the card against the
    same call on the CPU, rtol 1e-4 / atol 1e-6."""
    import torch
    from mlprobs_tpu_torch.align import pairwise
    from mlprobs_tpu_torch.ops import em

    x, y = (torch.from_numpy(s.astype("int64")) for s in seqs[:2])
    out = []
    for d in (dev, torch.device("cpu")):
        p = pairwise.hmm5_dict(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = em.hmm5_em_step(x.to(d), y.to(d), p, train_emissions=True)
        res = {k: v.cpu() for k, v in res.items()}
        out.append((res, time.perf_counter() - t0))
    (card, t_card), (cpu, t_cpu) = out
    rel = {k: float(((card[k] - cpu[k]).abs()
                     / cpu[k].abs().clamp(min=1e-30)).max()) for k in cpu}
    ok = all(torch.allclose(card[k], cpu[k], rtol=1e-4, atol=1e-6)
             and bool(torch.isfinite(card[k]).all()) for k in cpu)
    rec = {"lx": len(seqs[0]), "ly": len(seqs[1]), "card_s": t_card,
           "cpu_s": t_cpu, "max_rel_err": rel, "ok": ok,
           "gap_open": card["gap_open"].tolist(),
           "gap_extend": card["gap_extend"].tolist()}
    print("[em] " + json.dumps(rec), flush=True)
    if not ok:
        fail(f"EM on the card disagrees with the CPU: {rec}")


def phase_library(dev, batch, msa):
    """[library]: `ops/qpx.local_posterior_qpx` at Lp = 512, B = 32 on the
    card against the CPU (atol 2e-5 with rtol 1e-3: the card's exp and
    log are not the CPU's, 1.3e-5 apart at most; the posteriors reach
    well above atol), and
    `ops/colscore.column_scores_torch` of the smoke family's MSA on the
    card against the host scores (atol 1e-6)."""
    import torch
    from mlprobs_tpu_torch.align import pairwise
    from mlprobs_tpu_torch.ops import colscore, qpx

    X, Y, LX, LY = batch(512, 32, seed=32)
    out = []
    for d in (dev, torch.device("cpu")):
        p = pairwise.local_dict(0.17, device=d)
        args = [t.to(d) for t in (X, Y, LX, LY)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        post = qpx.local_posterior_qpx(*args, p["trans"], p["log_stay"],
                                       p["lmatch"], p["lins"]).cpu()
        out.append((post, time.perf_counter() - t0))
    (pk, tk), (pc, tc) = out
    big = pc > 1e-2
    rows = msa.rows
    cs_card = colscore.column_scores_torch(torch.from_numpy(rows).to(dev))
    cs_host = colscore.column_scores(rows)
    cs_err = float(abs(cs_card.cpu().double().numpy() - cs_host).max())
    rec = {"local_qpx": {"lp": 512, "b": 32, "card_s": tk, "cpu_s": tc,
                         "max_abs_err": float((pk - pc).abs().max()),
                         "max_rel_err_above_1e-2": float(
                             ((pk - pc).abs()[big] / pc[big]).max()),
                         "allclose": torch.allclose(pk, pc, rtol=1e-3,
                                                    atol=2e-5),
                         "finite": bool(torch.isfinite(pk).all()),
                         "max": float(pk.max())},
           "column_scores": {"n": int(rows.shape[0]),
                             "columns": int(rows.shape[1]),
                             "max_abs_err": cs_err}}
    print("[library] " + json.dumps(rec), flush=True)
    if (not rec["local_qpx"]["allclose"] or rec["local_qpx"]["max"] < 2e-3
            or not rec["local_qpx"]["finite"] or cs_err > 1e-6):
        fail(f"a library function on the card disagrees: {rec}")


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke run of the "
                                 "PyTorch/CUDA port (every phase by default).")
    ap.add_argument("--only", choices=["multichip"],
                    help="build the kernels and run this phase alone (with "
                         "its own unsharded reference runs), for a machine "
                         "with several cards")
    args = ap.parse_args()
    # every phase runs unsharded whatever the environment says, the
    # subprocesses of [bench] and [annot] too; [multichip] sets its meshes
    # in place of pairwise._mesh
    os.environ["MLPROBS_MULTICHIP"] = "0"
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
        from mlprobs_tpu_torch.ops.kernels import qpx_kernel as qk
        from mlprobs_tpu_torch.ops.kernels import viterbi_kernel as vk
        from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as wk
        from mlprobs_tpu_torch.pipeline.driver import run_pipeline
        from mlprobs_tpu_torch.utils import host
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
    # scratch files of the phases that drive the CLI or other processes
    work = ROOT / "_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    deferred: list = []   # failures recorded so that later phases still run

    def check_hash(name, got):
        if got != EXPECTED_HASHES[name]:
            deferred.append(f"[{name}] hash {got}, expected "
                            f"{EXPECTED_HASHES[name]}")

    def clock(phase):
        print(f"[clock] {phase} starts at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 2. build --------------------------------------------------------
    info = build.build_all()
    print(f"[build] {'+'.join(build.KERNELS)} nvcc in {info['seconds']:.2f} s",
          flush=True)
    for name, log in info["logs"].items():
        for line in ptxas_summary(log):
            print(f"[build:{name}] {line}")
    t0 = time.perf_counter()
    host.lib()
    print(f"[build] host library (csrc/host.cpp) g++ in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    wk.reset_launch_counts()

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
        with PlainTailCalls() as plain:
            out = fn()
            torch.cuda.synchronize()
        wall_ = time.perf_counter() - t0
        if any(plain.values()):
            fail(f"a path ran the plain MWT or top-k on the card: {plain}")
        launched = launch_counts()
        timers = {k[5:]: v for k, v in STATS.to_dict().items()
                  if k.startswith("time.")}
        return out, wall_, launched, torch.cuda.max_memory_allocated(), \
            timers

    # ---- 3. kernels against their plain versions -------------------------
    clock("check")
    def batch(lp, b, seed, device=None):
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
        d = device or dev
        return (X.to(d), Y.to(d), lens.to(torch.int32).to(d),
                ly.to(torch.int32).to(d))

    records = synthetic_family(48, 330, 470, sub=0.5, indel=0.1, seed=48)
    small = synthetic_family(6, 40, 90, sub=0.2, indel=0.05, seed=5)
    if args.only == "multichip":
        clock("multichip")
        seqs = [degap(encode(s)) for _, s in records]
        stats = aligner.family_viterbi_stats(seqs, device=dev)
        leave = aligner.mp.adaptive_leave_prob(stats.avg_pid)
        phase_multichip(dev, batch, records, small, seqs, leave, drive,
                        valid_msa)
        shutil.rmtree(work, ignore_errors=True)
        print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

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

    def check_features(X, Y, LX, LY):
        # the Viterbi and qpx kernels: every output bit for bit
        eq = feature_kernels_equal(X, Y, LX, LY)
        print(f"[check] viterbi+qpx Lp={X.shape[1]} B={X.shape[0]} "
              f"bit-equal: " + json.dumps(eq), flush=True)
        if not all(eq.values()):
            fail(f"the Viterbi or qpx kernel differs from its plain "
                 f"version at Lp={X.shape[1]} B={X.shape[0]}: {eq}")

    check_features(*batch(128, 8, seed=136))

    # timing at the main path's shapes: Lp=512, the budgeted batch, mix
    clock("timing")
    def cuda_ms(fn, reps, warm=True):
        # warm=False: one timed call alone, for the plain-torch qpx loop,
        # which compiles nothing and takes seconds a call
        if warm:
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
    # the Viterbi and qpx kernels on the same batch, after holding them
    # there; their plain versions once each (seconds a call)
    check_features(X, Y, LX, LY)
    worst["viterbi"] = worst["qpx"] = 0.0   # bit-equal, checked above
    tabs_v = pairwise.viterbi_tables(pairwise.mp.blosum62(), dev)
    p5 = pairwise._qpx_params(dev)
    timing["viterbi"] = (
        cuda_ms(lambda: vk.viterbi_stats(X, Y, LX, LY, *tabs_v), 7),
        cuda_ms(lambda: vk.viterbi_reference(X, Y, LX, LY, *tabs_v), 1,
                warm=False),
    )
    timing["qpx"] = (
        cuda_ms(lambda: qk.hmm5_fb(X, Y, LX, LY, *p5), 7),
        cuda_ms(lambda: qpx.hmm5_fb_qpx(X, Y, LX, LY, *p5), 1, warm=False),
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
    # Viterbi: x, y, lx, ly and the table block read once; the int8
    # direction plane, four (B,) outputs and the (2Lp, B) scores written.
    # qpx: the same inputs; the two padded (D+2, B, W+1) planes and the
    # totals written
    ins = 2 * b * lp + 8 * b
    bounds["viterbi"] = bound(
        ins + vk.TAB_SIZE * 4 + D * b * W + 16 * b + 2 * lp * b * 4,
        VITERBI_OPS_CELL * D * W * b)
    bounds["qpx"] = bound(
        ins + qk.TAB_SIZE * 4 + 2 * (D + 2) * b * (W + 1) * 4 + 4 * b,
        QPX_OPS_CELL * D * W * b)
    # the sweep of each single-model set on the same batch: which kind
    # sets the pace of the mix launch
    single = {m: cuda_ms(lambda m=m: wk.sweep(X, Y, zero, zero, LX, LY,
                                              tabs_f, models=(m,)), 7)
              for m in models}
    rec = {k: {"ms": v[0], "plain_ms": v[1], "bound_ms": bounds[k][0]}
           for k, v in timing.items()}
    rec["viterbi"]["share_of_bound"] = bounds["viterbi"][0] / timing[
        "viterbi"][0]
    rec["sweep_single_ms"] = single
    rec["qpx"]["parent_recorded_ms"] = QPX_PARENT_MS   # not measured here
    print(f"[timing] mix Lp={lp} B={b} (combine_b104: B={b_last}): "
          + json.dumps(rec), flush=True)
    del fk, rk, fk2, rk2, comb_modes, f_, r_, X2, Y2, LX2, LY2

    # ---- 4. the main path --------------------------------------------------
    clock("main")
    report: dict = {}
    STATS.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    with PlainTailCalls() as plain:
        msa = aligner.align_family(records, config="pnp", strategy=0,
                                   report=report, device="cuda")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(plain.values()):
        fail(f"the main path ran the plain MWT or top-k on the card: "
             f"{plain}")
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    stages = {k[5:]: v for k, v in STATS.to_dict().items()
              if k.startswith("time.")}
    print("[main] " + json.dumps({
        "family": "synthetic N=48 L=330-470 sub=0.5 indel=0.1 seed=48",
        "wall_s": wall, "stages_s": stages, "launches": launches,
        "peak_device_bytes": peak, "report": report,
        "content_hash": msa.content_hash(), "columns": msa.length,
    }), flush=True)
    if unlaunched(launches, BASE_KERNELS):
        fail(f"the main path did not run every kernel: {launches}")
    check_hash("main", msa.content_hash())
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
    del t_p, both, one
    clock("relax")
    phase_relax(t_k, records, deferred)
    del t_k

    # ---- 5. [qp]: the realigner's posterior batch ---------------------------
    clock("qp")
    qtf, qtr = pairwise._wf_tables("qp", None, dev)
    qtf_c, qtr_c = pairwise._wf_tables("qp", None, "cpu")
    X, Y, LX, LY = batch(128, 8, seed=128)
    cpu_args = [t.cpu() for t in (X, Y, LX, LY)]
    p5 = pairwise._qpx_params(dev)
    ph_k = qk.hmm5_posterior(X, Y, LX, LY, *p5)
    ph_c = qpx.hmm5_posterior_qpx(*cpu_args, *pairwise._qpx_params(
        torch.device("cpu")))
    post_k = pairwise._qpx_combined_skew(X, Y, LX, LY, qtf, qtr)
    post_c = pairwise._qpx_combined_skew(*cpu_args, qtf_c, qtr_c)
    qp_err = float((post_k.cpu() - post_c).abs().max())
    qp_rec = {"lp": 128, "b": 8, "qp_post_err": qp_err,
              "hmm5_qpx_err": float((ph_k.cpu() - ph_c).abs().max()),
              "hmm5_qpx_bit_equal": bool(torch.equal(ph_k.cpu(), ph_c))}
    print("[qp] card (kernels) vs cpu (plain): " + json.dumps(qp_rec),
          flush=True)
    if qp_err > TOL["post"] or not qp_rec["hmm5_qpx_bit_equal"]:
        fail(f"qp posterior on the card disagrees with the CPU: {qp_rec}")
    del ph_k, ph_c, post_k, post_c

    lp = 512
    bq = pairwise._wf_batch_size(lp, dev)
    X, Y, LX, LY = batch(lp, bq, seed=11)
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_batch = cuda_ms(lambda: pairwise._qpx_combined_skew(
        X, Y, LX, LY, qtf, qtr), 3)
    qp_peak = torch.cuda.max_memory_allocated() - base_bytes
    t_fb = cuda_ms(lambda: qk.hmm5_fb(X, Y, LX, LY, *p5), 7)
    t_fb_plain = cuda_ms(lambda: qpx.hmm5_fb_qpx(X, Y, LX, LY, *p5), 1,
                         warm=False)
    t_sw = cuda_ms(lambda: wk.sweeps(X, Y, LX, LY, qtf, qtr,
                                     ("partition",)), 3)
    per_cell = qp_peak / (bq * lp * lp)
    qp_rec = {"lp": lp, "b": bq, "qpx_kernels_ms": t_fb,
              "qpx_plain_ms": t_fb_plain,
              "partition_sweeps_ms": t_sw, "qp_batch_ms": t_batch,
              "peak_bytes": qp_peak,
              "peak_bytes_per_pair_cell": per_cell, "budget_per_cell": 80}
    print("[qp] timing: " + json.dumps(qp_rec), flush=True)
    if per_cell > 80:
        fail(f"a qp batch outgrows the batch budget: {qp_rec}")
    _, prof = profiled(lambda: qk.hmm5_fb(X, Y, LX, LY, *p5))
    print(f"[qp] profile of the qpx kernel's forward+backward (Lp={lp}, "
          f"B={bq}): " + json.dumps(prof), flush=True)
    # the qp route's MWT and top-k on its plane: combine's GIVEN kind
    # against the plain tail, in each mode the route runs
    post = pairwise._qpx_combined_skew(X, Y, LX, LY, qtf, qtr)
    Dq, Wq = 2 * lp + 1, lp + 1
    given = {}
    for name, kw in (("topk16", {"topk": 16}),
                     ("topk16_matches", {"topk": 16, "with_matches": True}),
                     ("dense", {})):
        got = wk.mwt_topk(post, LX, LY, cutoff=0.01, **kw)
        want = wk.mwt_topk_reference(post, LX, LY, cutoff=0.01, **kw)
        k = kw.get("topk", 0)
        equal = all(torch.equal(a, b) for a, b in zip(got[2 * bool(k):],
                                                      want[2 * bool(k):]))
        if k:
            pos = want[0] > 0
            equal = (equal and torch.equal(got[0], want[0])
                     and torch.equal(got[1][pos], want[1][pos]))
        nbytes = (Dq * bq * Wq * 4 + 8 * bq + Dq * bq * k * 8
                  + 4 * bq * (1 + bool(kw.get("with_matches"))))
        given[name] = {
            "equal": bool(equal),
            "ms": cuda_ms(lambda kw=kw: wk.mwt_topk(post, LX, LY, **kw), 7),
            "plain_ms": cuda_ms(lambda kw=kw: wk.mwt_topk_reference(
                post, LX, LY, **kw), 1, warm=False),
            "bound_ms": bound(nbytes, GIVEN_OPS_CELL * Dq * Wq * bq)[0]}
    print(f"[qp] MWT and top-k on combine's GIVEN kind (Lp={lp}, B={bq}): "
          + json.dumps(given), flush=True)
    if not all(v["equal"] for v in given.values()):
        fail(f"combine's GIVEN kind differs from the plain tail: {given}")
    del X, Y, LX, LY, post

    # ---- 6. [pipeline]: cli align's path on the smoke family -------------
    clock("pipeline")
    # the realigner's launches (a snapshot around it): combine's GIVEN
    # kind once per qp batch, as many as the qpx kernel's launches
    qp_real = aligner._align_quickprobs
    realigner_launches = dict.fromkeys(KERNELS, 0)

    def realigner_counted(*a, **kw):
        before = launch_counts()
        try:
            return qp_real(*a, **kw)
        finally:
            for n, v in launch_counts().items():
                realigner_launches[n] += v - before[n]

    aligner._align_quickprobs = realigner_counted
    try:
        (pmsa, prep), pwall, plaunch, ppeak, ptimers = drive(
            lambda: run_pipeline(records, device="cuda"))
    finally:
        aligner._align_quickprobs = qp_real
    decisions = {k: getattr(prep, k) for k in (
        "strategy", "realign_mode", "min_length_class", "num_realign_blocks",
        "blocks_realigned", "blocks_accepted", "whole_family_realign",
        "crash_fallback", "device_suspect")}
    print("[pipeline] " + json.dumps({
        "family": "synthetic N=48 L=330-470 sub=0.5 indel=0.1 seed=48",
        "wall_s": pwall, "decisions": decisions, "marks_s": prep.timings,
        "factor": prep.factor, "avg_pid": prep.avg_pid,
        "stage_timers_s": ptimers, "launches": plaunch,
        "realigner_launches": realigner_launches,
        "peak_device_bytes": ppeak, "engines": prep.engines,
        "final_hash": prep.final_hash, "columns": pmsa.length,
        "block_errors": prep.block_errors, "error": prep.error,
    }, default=float), flush=True)
    if prep.crash_fallback or prep.block_errors:
        fail(f"the pipeline fell back or lost a block: {prep.error} "
             f"{prep.block_errors}")
    if not valid_msa(pmsa, records):
        fail("the pipeline's MSA does not degap to its input records")
    if unlaunched(plaunch, KERNELS):
        fail(f"the pipeline did not run every kernel: {plaunch}")
    if not 0 < realigner_launches["combine"] == plaunch["qpx"]:
        fail(f"the qp batches did not each run combine once: "
             f"{plaunch['qpx']} qpx launches, realigner "
             f"{realigner_launches}")
    check_hash("pipeline", prep.final_hash)

    # ---- 7. [realigner]: align_family(config="quickprobs") ---------------
    if prep.whole_family_realign:
        qstages = {k: v for k, v in ptimers.items() if k.startswith("qp_")}
        qrec = {"source": "phase [pipeline]: whole-family realign",
                "stages_s": qstages, "engines": prep.engines,
                "content_hash": prep.final_hash,
                "peak_device_bytes": ppeak, "launches": realigner_launches}
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
        if unlaunched(qlaunch, REALIGN_KERNELS):
            fail(f"the realigner did not run its kernels: {qlaunch}")
    print("[realigner] " + json.dumps(qrec, default=float), flush=True)
    if qengine != "device":
        fail(f"the realigner's consistency left the device: {qrec}")

    # ---- 8. [pipeline-cpu]: the same decisions on the card and the CPU ---
    clock("pipeline-cpu")
    # The small family takes the whole-family realign, as the smoke family
    # does; its second run forces classifier 3 to RIR (as the CPU tests
    # do) so that the block realign runs on the card too.
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
        if case == "as-classified":
            small_hash = crep.final_hash
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
        if crep.final_hash != hrep.final_hash:
            deferred.append(f"[pipeline-cpu] {case}: card hash "
                            f"{crep.final_hash}, CPU {hrep.final_hash}")
        if crep.crash_fallback or crep.block_errors:
            fail(f"the small family fell back or lost a block: "
                 f"{crep.error} {crep.block_errors}")
        if not (valid_msa(cmsa, small) and valid_msa(hmsa, small)):
            fail("a small-family MSA does not degap to its input records")
        if unlaunched(claunch, KERNELS):
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
    if not valid_msa(tmsa, pair) or unlaunched(tlaunch, REALIGN_KERNELS):
        fail(f"the two-sequence realign failed on the card: {tlaunch}")
    if tmsa.content_hash() != tcpu.content_hash():
        deferred.append(f"[pipeline-cpu] two-sequence realign: card hash "
                        f"{tmsa.content_hash()}, CPU {tcpu.content_hash()}")

    # ---- 9. [np]: the non-progressive base aligner ------------------------
    clock("np")
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
    check_hash("np", nmsa.content_hash())
    if unlaunched(nlaunch, BASE_KERNELS):
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
    if unlaunched(claunch, BASE_KERNELS):
        fail(f"the NP family's pipeline did not run every kernel: {claunch}")

    # ---- 10. [sector]: a family over the dense tensor's budget -------------
    clock("sector")
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

    stats_real = aligner.family_viterbi_stats

    def stats_kept(*a, **kw):
        relax_seen["stats"] = stats_real(*a, **kw)
        return relax_seen["stats"]

    aligner.sectorlib.relax_sector_device = relax_measured
    aligner.family_viterbi_stats = stats_kept
    try:
        smsa, swall, slaunch, _, stimers = drive(
            lambda: aligner.align_family(big, config="pnp", report=srep,
                                         device="cuda"))
    finally:
        aligner.sectorlib.relax_sector_device = relax_real
        aligner.family_viterbi_stats = stats_real
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
    if not valid_msa(smsa, big) or unlaunched(slaunch, BASE_KERNELS):
        fail(f"the sector family's MSA or launches are wrong: {rec}")
    check_hash("sector", smsa.content_hash())
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

    # ---- 11. [determinism]: the host scatter and the sector family --------
    clock("determinism")
    phase_determinism_host(work)
    dlaunch = phase_sector_repeat(big, smsa.content_hash(),
                                  relax_seen["stats"], drive, deferred)

    # ---- 12. [long]: past 8,192 lanes ---------------------------------------
    clock("long")
    # The check runs at Lp = 8,320, the length the long family below
    # takes: past the short instances, so the sweep's long instance and
    # combine's cluster instance, in each mode the path runs, and the Viterbi
    # kernel at B = 2, its strips in rounds past 2,048 lanes (the card tests
    # hold 8,192, the short instances' last length, and 8,320 as well;
    # here one length keeps the run near half its limit, the plain
    # versions' 16,641-diagonal loops being the slow part).  The log2
    # totals get 2e-4 or 1e-6 of |l2t|, whichever is larger (past |l2t| =
    # 2,048 one f32 step is 2.4e-4, and the two sum the local model in
    # other orders).
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
        # the Viterbi kernel at B = 2, its strips in rounds
        Xv, Yv, LXv, LYv = batch(lp_chk, 2, seed=lp_chk + 1)
        v_equal = all(bool(torch.equal(a_, b_)) for a_, b_ in zip(
            vk.viterbi_stats(Xv, Yv, LXv, LYv, *tabs_v),
            vk.viterbi_reference(Xv, Yv, LXv, LYv, *tabs_v)))
        Dv, Wv = 2 * lp_chk + 1, lp_chk + 1
        v_ms = cuda_ms(lambda: vk.viterbi_stats(Xv, Yv, LXv, LYv, *tabs_v),
                       3)
        v_bound = bound(2 * 2 * lp_chk + 16 + vk.TAB_SIZE * 4
                        + Dv * 2 * Wv + 32 + 2 * lp_chk * 2 * 4,
                        VITERBI_OPS_CELL * Dv * Wv * 2)[0]
        del Xv, Yv, LXv, LYv
        chk = long_rec[f"check_lp{lp_chk}"] = {
            "viterbi_b2_bit_equal": v_equal, "viterbi_b2_ms": v_ms,
            "viterbi_b2_bound_ms": v_bound,
            "plane_err": e_plane, "scale_rows_differing": scale_rows,
            "l2t_kernel_plain": l2t_pairs, "l2t_ok": l2t_ok,
            "post_err": e_post, "pad_nonzero": pad_nonzero,
            "score_ok": torch.allclose(sc_k, sc_p, rtol=TOL["score_rtol"],
                                       atol=TOL["score_atol"]),
            "matches_equal": bool(torch.equal(nb_k, nb_p)),
            "topk_err": topk_err, "topk_lanes_equal": topk_lanes,
            "topk_score_matches_equal": topk_rest}
        print("[long] " + json.dumps(chk), flush=True)
        if not (v_equal and e_plane <= TOL["plane"] and scale_rows == 0
                and l2t_ok
                and e_post <= TOL["post"] and pad_nonzero == 0
                and chk["score_ok"] and chk["matches_equal"]
                and topk_err <= TOL["topk"] and topk_lanes and topk_rest):
            fail(f"a kernel disagrees with its plain version at "
                 f"Lp={lp_chk}: {chk}")
        worst["sweep"] = max(worst["sweep"], e_plane)
        worst["combine"] = max(worst["combine"], e_post)
        del fk, rk, post_k, vals_w, lanes_w

    long_check(8320)
    # the kernels' times beside their byte bounds, their shares of them
    # and the plans the wrappers chose
    long_times = {}
    for lp_, b_ in ((8192, 1), (8320, 1), (16384, 1), (8320, 2)):
        X, Y, LX, LY = batch(lp_, b_, seed=lp_)
        z1 = torch.zeros((b_,), dtype=torch.int32, device=dev)
        D_, W_ = 2 * lp_ + 1, lp_ + 1
        t_sw = cuda_ms(lambda: wk.sweep(X, Y, z1, z1, LX, LY, tabs_f,
                                        models=models), 3)
        fk, rk = sweeps(wk.sweep, X, Y, LX, LY, tabs_f, tabs_r, models)
        t_cm = cuda_ms(lambda: wk.combine(fk, rk, LX, LY, models,
                                          with_matches=True, topk=16), 3)
        t_cd = cuda_ms(lambda: wk.combine(fk, rk, LX, LY, models), 3)
        t_vit = cuda_ms(lambda: vk.viterbi_stats(X, Y, LX, LY, *tabs_v), 3)
        sw_b = bound(2 * lp_ * b_ + 16 * b_
                     + nm * (D_ * W_ * b_ + D_ * b_ + b_) * 4,
                     sum(SWEEP_OPS[m] for m in models) * D_ * W_ * b_)[0]
        cd_b = (2 * nm * (D_ * W_ * b_ + D_ * b_ + b_) * 4 + 8 * b_
                + D_ * W_ * b_ * 4 + 4 * b_) / CARD_BYTES * 1e3
        vt_b = bound(2 * lp_ * b_ + 8 * b_ + vk.TAB_SIZE * 4
                     + D_ * W_ * b_ + 16 * b_ + 8 * lp_ * b_,
                     VITERBI_OPS_CELL * D_ * W_ * b_)[0]
        long_times[f"lp{lp_}_b{b_}"] = {
            "sweep_ms": t_sw, "sweep_bound_ms": sw_b,
            "sweep_share_of_bound": sw_b / t_sw,
            "sweep_plan": wk.sweep_plan(lp_)._asdict(),
            "combine_topk16_matches_ms": t_cm, "combine_dense_ms": t_cd,
            "combine_dense_bound_ms": cd_b,
            "combine_dense_share_of_bound": cd_b / t_cd,
            "combine_plan": wk.combine_plan(lp_, 16)._asdict(),
            "viterbi_ms": t_vit, "viterbi_bound_ms": vt_b,
            "viterbi_share_of_bound": vt_b / t_vit}
        del fk, rk
    print("[long] mix times: " + json.dumps(long_times), flush=True)
    # cli base on a family with one sequence past 8,192 residues
    lfam = synthetic_family(3, 8250, 8250, sub=0.3, indel=0.05, seed=82)
    lfam = [lfam[0], (lfam[1][0], lfam[1][1][2000:2700]),
            (lfam[2][0], lfam[2][1][5000:5500])]
    lrep: dict = {}
    lmsa, lwall, llaunch, lpeak, ltimers = drive(
        lambda: aligner.align_family(lfam, config="pnp", report=lrep,
                                     device="cuda"))
    rec = {"family": "synthetic N=3 L=8250 sub=0.3 indel=0.05 seed=82, "
                     "two cut to 700 and 500 residues",
           "entry": "cli base (align_family config=pnp)",
           "wall_s": lwall, "stages_s": ltimers, "launches": llaunch,
           "report": lrep, "peak_device_bytes": lpeak,
           "valid": valid_msa(lmsa, lfam),
           "content_hash": lmsa.content_hash(), "columns": lmsa.length}
    print("[long] " + json.dumps(rec, default=float), flush=True)
    if not valid_msa(lmsa, lfam) or unlaunched(llaunch, BASE_KERNELS):
        fail(f"the long family did not align on the card: {rec}")
    check_hash("long", rec["content_hash"])

    # ---- 13. [qp-scaled]: MLPROBS_QP_EXACT=0 -------------------------------
    clock("qp-scaled")
    qlaunch_scaled, _, scaled_hash = phase_qp_scaled(
        dev, batch, cuda_ms, records, prep.final_hash, small, drive,
        valid_msa, TOL)
    check_hash("qp_scaled", scaled_hash)

    # ---- 14. [scan]: the row-scan posteriors against combine ---------------
    clock("scan")
    def kernel_dense(X, Y, LX, LY, leave_prob):
        tf, tr = pairwise._wf_tables("mix", leave_prob, dev)
        post, _ = wk.posterior(X, Y, LX, LY, tf, tr,
                               models=MODEL_SETS["mix"], with_matches=False)
        return wk.wf.unskew_posterior(post)

    phase_scan(dev, seqs, leave, kernel_dense)

    # ---- 15. [bench] and [annot]: the CLI in a subprocess ------------------
    clock("bench")
    bench_fams = {f"fam{k}": synthetic_family(48, 330, 470, sub=0.5,
                                              indel=0.1, seed=k)
                  for k in (48, 49)}
    blaunch = phase_bench(work, bench_fams, pmsa, ())
    clock("annot")
    alaunch = phase_annot(work, records, ())
    shutil.rmtree(work, ignore_errors=True)

    # ---- 17.-19. [multichip], [em], [library] -----------------------------
    clock("multichip")
    mlaunch = phase_multichip(dev, batch, records, small, seqs, leave,
                              drive, valid_msa, main_hash=msa.content_hash(),
                              small_hash=small_hash)
    clock("em")
    phase_em(dev, seqs)
    clock("library")
    phase_library(dev, batch, msa)
    if deferred:
        fail("; ".join(deferred))

    kernels = []
    for name, src, replaces in (
        ("sweep", "mlprobs_tpu_torch/ops/kernels/csrc/sweep.cu",
         "mlprobs_tpu/ops/pallas/wavefront_kernel.py:546"),
        ("combine", "mlprobs_tpu_torch/ops/kernels/csrc/combine.cu",
         "mlprobs_tpu/ops/pallas/wavefront_kernel.py:857"),
        # not TPU kernels: the JAX package's XLA scans of the same function
        ("viterbi", "mlprobs_tpu_torch/ops/kernels/csrc/viterbi.cu",
         "mlprobs_tpu/ops/wavefront.py:578"),
        ("qpx", "mlprobs_tpu_torch/ops/kernels/csrc/qpx.cu",
         "mlprobs_tpu/ops/qpx.py:157"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": plaunch[name],
            "launches_by_path": {"base": launches[name],
                                 "pipeline": plaunch[name],
                                 "realigner": qrec["launches"][name],
                                 "np": nlaunch[name],
                                 "sector": slaunch[name],
                                 "sector_again": dlaunch[name],
                                 "long": llaunch[name],
                                 "qp_scaled": qlaunch_scaled[name],
                                 "bench": blaunch[name],
                                 "annot": alaunch[name],
                                 "multichip": mlaunch[name]},
            "max_abs_err": worst[name], "ms": timing[name][0],
            "plain_ms": timing[name][1], "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": None,
        })
        if name == "combine":   # the qp route's MWT and top-k ([qp])
            kernels[-1]["given_kind"] = given
        if name == "sweep":
            kernels[-1]["design"] = (
                "4 lanes a thread in registers, one barrier a diagonal; past "
                "8,192 lanes a cluster of up to 16 blocks (4 or 8 lanes a "
                "thread), the warps' maxima exchanged in distributed shared "
                "memory")
        if name == "combine":
            kernels[-1]["design"] = (
                "producer warps and MWT warps on an mbarrier ring; past "
                "4,096 lanes a cluster of up to 16 blocks a pair, each "
                "block its own lanes, the DP edge handed to the next block "
                "through distributed shared memory, the blocks' top-k "
                "lists merged after the last diagonal")
        if name == "viterbi":
            kernels[-1]["design"] = (
                "redesigned for Hopper: states in registers, 4 lanes a "
                "thread, warp strips joined by shared-memory rings, the "
                "walk a 32x32 window at a time")
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
