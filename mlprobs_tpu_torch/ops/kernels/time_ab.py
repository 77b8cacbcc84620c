"""Time the CUDA kernels of one checkout of the port at the main path's
shape (Lp = 512, B = 256), for comparing two checkouts on one card.

    python3 mlprobs_tpu_torch/ops/kernels/time_ab.py --root DIR [--reps 21]
        [--align N]
    python3 mlprobs_tpu_torch/ops/kernels/time_ab.py --root DIR --viterbi
        [--split-at REGEX] [--lanes 1,2,8] [--edit TAG:REGEX=>TEXT]
    python3 mlprobs_tpu_torch/ops/kernels/time_ab.py --root DIR --long
        [--shape 8320x1 --shape 16384x1 ...] [--long-family N]
        [--crossover 2048,4096]

DIR is the root of the checkout whose `mlprobs_tpu_torch` is timed (its
kernels build there on first use).  Run two checkouts on one card, one
after the other, A B B A, and compare medians only within such a run.
Prints one JSON line: the root, the card's name and power limit, and the
median and every time in milliseconds, from CUDA events, of the forward
sweep and the dense combine (three models), of the qpx forward/backward,
of the Viterbi kernel, and of one whole qp batch of the realigner (`_qp_exact_fn`: the
qpx posterior, the partition sweeps and posterior, the MWT and top-k;
at most 5 runs).  With --align N, also N runs of each end-to-end path on
the 48-sequence smoke family of `chip_smoke.py`, after one warm-up run
each: `cli align`'s pipeline (`run_pipeline`) on the default qpx route
and with MLPROBS_QP_EXACT=0, then `base` (`align_family`, pnp) and `base
-p 1`: wall seconds, the stage timers and the MSA's hash.

With --long, only sweep and combine at each --shape LPxB (default
8320x1, 16384x1, 8320x2; three models, random pairs, the first x of full
length): the forward sweep, combine dense, with top-k 16 and match
counts, and the GIVEN kind (`mwt_topk`, top-k 16 with match counts) on
the dense plane, each time beside a digest of its outputs (two sums of
their bits), so that two checkouts' outputs compare bit for bit; with
--long-family N, N runs of `base` on chip_smoke.py's long family (one
sequence of 8,250 residues), after one warm-up: wall seconds, stages and
the MSA's hash; with --crossover LPS (a checkout with `combine_plan`),
combine and the sweep at each Lp and B = 1 and 2 on the instance the plan
picks and on the other one (a plan's crossover, `COMBINE_CLUSTER_FROM` /
`SWEEP_LONG_FROM`, moved for the call).

With --viterbi, only the feature pass's Viterbi kernel (`viterbi_stats`),
at the main shape and at B = 1 and B = 2, Lp = 8,320 (the long family's
length): the whole kernel, then its forward alone.  The forward alone is
a build of DIR's `csrc/viterbi.cu` into a temporary directory with a
`return;` inserted before the first source line that matches --split-at
(the line that starts the traceback walk; a parent whose source has no
such line takes its own pattern), launched through DIR's own wrapper;
its outputs are not used.  The walk's time is the difference.
With --lanes 1,2,4,8, also builds of the kernel with its lanes a thread
(`LANES`) set to each count, timed the same way and held bit for bit
against the plain version on the main batch's first 8 pairs; with
--edit TAG:REGEX=>REPLACEMENT, a build of the source with that regex
substitution (a measurement of what a part of the kernel costs).  Needs
a CUDA card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--lp", type=int, default=512)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--align", type=int, default=0,
                    help="runs of the smoke family's pipeline a qp route")
    ap.add_argument("--viterbi", action="store_true",
                    help="time the Viterbi kernel alone, whole and forward")
    ap.add_argument("--long", action="store_true",
                    help="time sweep and combine alone at each --shape")
    ap.add_argument("--shape", action="append", default=[],
                    help="with --long: LPxB, e.g. 16384x1 (repeatable)")
    ap.add_argument("--long-family", type=int, default=0,
                    help="with --long: runs of base on the long family")
    ap.add_argument("--crossover", default="",
                    help="with --long: Lp list, each instance timed there")
    ap.add_argument("--split-at", default=r"^\s+// The walk:",
                    help="regex: the kernel source line the forward-only "
                         "build returns before")
    ap.add_argument("--lanes", type=lambda v: [int(k) for k in v.split(",")],
                    default=[], help="with --viterbi: also builds of the "
                    "kernel at these lanes a thread, e.g. 1,2,4,8")
    ap.add_argument("--edit", action="append", default=[],
                    help="with --viterbi: TAG:REGEX=>REPLACEMENT, a build of "
                    "the kernel with the source so edited (repeat a TAG to "
                    "make several edits in one build)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_ab: no CUDA card")
    from mlprobs_tpu_torch.align import pairwise
    from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as wk

    assert wk.__file__.startswith(root), wk.__file__
    dev = torch.device("cuda")
    lp, b, models = args.lp, args.batch, ("hmm5", "partition", "local")
    X, Y, LX, LY = pair_batch(lp, b, 7, dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    if args.viterbi:
        print(json.dumps({"root": root, "card": card,
                          **viterbi_times(X, Y, LX, LY, args)}), flush=True)
        return
    if args.long:
        del X, Y, LX, LY
        print(json.dumps({"root": root, "card": card,
                          **long_times(args)}), flush=True)
        return
    zero = torch.zeros((b,), dtype=torch.int32, device=dev)
    tabs_f, tabs_r = pairwise._wf_tables("mix", 0.17, dev)
    fwd = wk.sweep(X, Y, zero, zero, LX, LY, tabs_f, models=models)
    rev = wk.sweep(X.flip(1).contiguous(), Y.flip(1).contiguous(),
                   (lp - LX).int(), (lp - LY).int(), LX, LY, tabs_r,
                   models=models, emit_pre=True)

    def times(fn, reps=args.reps):
        return cuda_times(fn, reps)

    rec = {
        "root": root, "lp": lp, "batch": b, "models": list(models),
        "card": card,
        "sweep": times(lambda: wk.sweep(X, Y, zero, zero, LX, LY, tabs_f,
                                        models=models)),
        "combine": times(lambda: wk.combine(fwd, rev, LX, LY, models)),
    }
    del fwd, rev
    from mlprobs_tpu_torch.ops.kernels import qpx_kernel as qk

    p5 = pairwise._qpx_params(dev)
    rec["qpx"] = times(lambda: qk.hmm5_fb(X, Y, LX, LY, *p5))
    from mlprobs_tpu_torch.ops.kernels import viterbi_kernel as vk

    tabs_v = pairwise.viterbi_tables(pairwise.mp.blosum62(), dev)
    rec["viterbi"] = times(lambda: vk.viterbi_stats(X, Y, LX, LY, *tabs_v))
    qtabs = pairwise._wf_tables("qp", None, dev)
    qp = pairwise._qp_exact_fn(False, lambda d: qtabs)
    rec["qp_batch"] = times(lambda: qp(X, Y, LX, LY), min(args.reps, 5))
    if args.align:
        del X, Y, LX, LY, zero, qp
        rec["align"] = align_runs(args.align)
    print(json.dumps(rec), flush=True)


def pair_batch(lp, b, seed, dev):
    """b random pairs padded to lp, lengths in [lp/2, lp], the first x of
    full length: (X, Y, LX, LY) on dev."""
    import torch

    g = torch.Generator().manual_seed(seed)
    lx = torch.randint(lp // 2, lp + 1, (b,), generator=g)
    ly = torch.randint(lp // 2, lp + 1, (b,), generator=g)
    lx[0] = lp
    X = torch.full((b, lp), 20, dtype=torch.int8)
    Y = torch.full((b, lp), 20, dtype=torch.int8)
    for k in range(b):
        X[k, : lx[k]] = torch.randint(0, 20, (int(lx[k]),), generator=g)
        Y[k, : ly[k]] = torch.randint(0, 20, (int(ly[k]),), generator=g)
    return (X.to(dev), Y.to(dev), lx.to(torch.int32).to(dev),
            ly.to(torch.int32).to(dev))


def cuda_times(fn, reps):
    """{median_ms, ms}: reps calls of fn, each timed by CUDA events,
    after one warm-up call."""
    import torch

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
    return {"median_ms": statistics.median(out), "ms": out}


def digest(t) -> list:
    """Two sums of a tensor's bits (as int64, the second weighted by the
    position mod 65,521): equal tensors give equal digests, and a tensor
    that differs in any bit almost surely does not."""
    import torch

    bits = t.contiguous().view(-1).view(torch.int32)
    total, weighted, step = 0, 0, 1 << 26
    for a in range(0, bits.numel(), step):
        x = bits[a:a + step].to(torch.int64)
        w = torch.arange(a, a + x.numel(), device=x.device) % 65521 + 1
        total += int(x.sum())
        weighted += int((x * w).sum())
    return [total, weighted]


def long_times(args) -> dict:
    """sweep and combine at each --shape, digests of their outputs; the
    long family's `base` runs; each instance at the --crossover lengths."""
    import torch

    from mlprobs_tpu_torch.align import pairwise
    from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as wk

    dev = torch.device("cuda")
    models = ("hmm5", "partition", "local")
    tabs_f, tabs_r = pairwise._wf_tables("mix", 0.17, dev)
    reps = min(args.reps, 5)
    out = {}
    defaults = (getattr(wk, "SWEEP_LONG_FROM", None),
                getattr(wk, "COMBINE_CLUSTER_FROM", None))

    def plans(lp):
        if not hasattr(wk, "combine_plan"):
            return None
        return {"sweep": list(wk.sweep_plan(lp)),
                "combine": list(wk.combine_plan(lp, 16))}

    def timed(fn):
        # a plan an instance cannot take is refused before any launch
        try:
            return cuda_times(fn, reps)
        except RuntimeError as e:
            return {"not_launched": str(e)[:200]}

    def shape(lp, b, digests=True):
        X, Y, LX, LY = pair_batch(lp, b, lp + b, dev)
        zero = torch.zeros((b,), dtype=torch.int32, device=dev)
        rec = {"plans": plans(lp),
               "sweep": timed(lambda: wk.sweep(
                   X, Y, zero, zero, LX, LY, tabs_f, models=models))}
        # the inputs of combine from the plans' own instances
        s0 = getattr(wk, "SWEEP_LONG_FROM", None)
        if s0 is not None:
            wk.SWEEP_LONG_FROM = defaults[0]
        fwd = wk.sweep(X, Y, zero, zero, LX, LY, tabs_f, models=models)
        rev = wk.sweep(X.flip(1).contiguous(), Y.flip(1).contiguous(),
                       (lp - LX).int(), (lp - LY).int(), LX, LY, tabs_r,
                       models=models, emit_pre=True)
        if s0 is not None:
            wk.SWEEP_LONG_FROM = s0
        rec["combine_dense"] = timed(lambda: wk.combine(
            fwd, rev, LX, LY, models))
        rec["combine_topk16_matches"] = timed(lambda: wk.combine(
            fwd, rev, LX, LY, models, with_matches=True, topk=16))
        c0 = getattr(wk, "COMBINE_CLUSTER_FROM", None)
        if c0 is not None:
            wk.COMBINE_CLUSTER_FROM = defaults[1]
        post, score = wk.combine(fwd, rev, LX, LY, models)
        if c0 is not None:
            wk.COMBINE_CLUSTER_FROM = c0
        rec["given_topk16_matches"] = timed(lambda: wk.mwt_topk(
            post, LX, LY, with_matches=True, topk=16))
        if digests:
            dig = {}
            for name, res in (("fwd", fwd), ("rev", rev)):
                for m in models:
                    for key in ("planes", "scales", "log2t"):
                        dig[f"{name}_{key}_{m}"] = digest(res[key][m])
            dig["post"], dig["score"] = digest(post), digest(score)
            for name, got in (
                    ("topk16_matches", wk.combine(
                        fwd, rev, LX, LY, models, with_matches=True,
                        topk=16)),
                    ("given_topk16_matches", wk.mwt_topk(
                        post, LX, LY, with_matches=True, topk=16))):
                for k, t in zip(("vals", "lanes", "score", "nb"), got):
                    dig[f"{name}_{k}"] = digest(t)
            rec["digests"] = dig
        del fwd, rev, post
        torch.cuda.empty_cache()
        return rec

    for sh in args.shape or ["8320x1", "16384x1", "8320x2"]:
        lp, b = (int(v) for v in sh.split("x"))
        out[f"lp{lp}_b{b}"] = shape(lp, b)
    if args.crossover and hasattr(wk, "combine_plan"):
        cross = {}
        for lp in (int(v) for v in args.crossover.split(",")):
            for b in (1, 2):
                got = {"picked": shape(lp, b, digests=False)}
                c0, s0 = wk.COMBINE_CLUSTER_FROM, wk.SWEEP_LONG_FROM
                # the other instance of each kernel (the one-block combine
                # takes at most 4,096 lanes, the short sweep 8,192, the
                # long sweep more than 1,024)
                wk.COMBINE_CLUSTER_FROM = lp + 1 if lp >= c0 else 1
                wk.SWEEP_LONG_FROM = lp + 1 if lp >= s0 else 1
                try:
                    got["other"] = shape(lp, b, digests=False)
                finally:
                    wk.COMBINE_CLUSTER_FROM, wk.SWEEP_LONG_FROM = c0, s0
                cross[f"lp{lp}_b{b}"] = got
        out["crossover"] = cross
    if args.long_family:
        out["long_family"] = long_family_runs(args.long_family)
    return out


def long_family_runs(n: int) -> dict:
    """n runs of `base` (pnp) on chip_smoke.py's long family, after one
    warm-up run: wall seconds, stage timers, hashes."""
    import torch

    from mlprobs_tpu_torch.align import aligner
    from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS
    from mlprobs_tpu_torch.utils.synth import synthetic_family

    os.environ["MLPROBS_MULTICHIP"] = "0"
    fam = synthetic_family(3, 8250, 8250, sub=0.3, indel=0.05, seed=82)
    fam = [fam[0], (fam[1][0], fam[1][1][2000:2700]),
           (fam[2][0], fam[2][1][5000:5500])]

    def run():
        return aligner.align_family(fam, config="pnp",
                                    device="cuda").content_hash()

    run()
    got = {"wall_s": [], "stages_s": [], "hashes": set()}
    for _ in range(n):
        STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got["hashes"].add(run())
        torch.cuda.synchronize()
        got["wall_s"].append(time.perf_counter() - t0)
        got["stages_s"].append({k[5:]: v for k, v in STATS.to_dict().items()
                                if k.startswith("time.")})
    got["median_wall_s"] = statistics.median(got["wall_s"])
    got["hashes"] = sorted(got["hashes"])
    return got


def variant_lib(tag: str, edit):
    """The Viterbi kernel library built from edit(text of csrc/viterbi.cu)
    into a temporary directory."""
    import ctypes
    import tempfile
    from pathlib import Path

    from mlprobs_tpu_torch.ops.kernels import build

    tmp = Path(tempfile.mkdtemp(prefix=f"viterbi_{tag}_"))
    src, out = tmp / "viterbi.cu", tmp / "libviterbi.so"
    src.write_text(edit((build.CSRC / "viterbi.cu").read_text()))
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                          str(out), str(src)], check=True,
                         capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.viterbi_launch.argtypes = build._ARGTYPES["viterbi"]
    lib.viterbi_launch.restype = ctypes.c_int
    lib.ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
                 if "registers" in ln or "spill" in ln]
    return lib


def cut_walk(split_at: str):
    """An edit that inserts `return;` before the first line matching
    split_at."""
    import re

    def edit(text):
        lines = text.splitlines(True)
        at = next(k for k, ln in enumerate(lines) if re.search(split_at, ln))
        return "".join(lines[:at] + ["return;\n"] + lines[at:])
    return edit


def set_lanes(k: int):
    """An edit that sets the kernel's lanes a thread (LANES) to k."""
    import re

    def edit(text):
        out, n = re.subn(r"constexpr int LANES = \d+;",
                         f"constexpr int LANES = {k};", text)
        if n != 1:
            raise ValueError("no LANES constant in csrc/viterbi.cu")
        return out
    return edit


def regex_edits(subs):
    """An edit that makes each (regex, replacement) substitution, each at
    least once."""
    import re

    def edit(text):
        for pat, repl in subs:
            text, n = re.subn(pat, repl, text)
            if n == 0:
                raise ValueError(f"no match for {pat!r} in csrc/viterbi.cu")
        return text
    return edit


def viterbi_times(X, Y, LX, LY, args) -> dict:
    """The Viterbi kernel whole and its forward alone, at the main shape
    (X, Y, LX, LY) and at B = 1 and B = 2, Lp = 8,320; then each build
    that --lanes and --edit ask for, timed the same way and held against
    the plain version on the main batch's first 8 pairs."""
    import contextlib

    import torch

    from mlprobs_tpu_torch.align import pairwise
    from mlprobs_tpu_torch.ops.kernels import build
    from mlprobs_tpu_torch.ops.kernels import viterbi_kernel as vk

    dev = X.device
    tabs = pairwise.viterbi_tables(pairwise.mp.blosum62(), dev)
    shapes = {f"lp{X.shape[1]}_b{X.shape[0]}": ((X, Y, LX, LY), args.reps)}
    for b in (1, 2):
        shapes[f"lp8320_b{b}"] = (pair_batch(8320, b, 8320, dev), 5)

    @contextlib.contextmanager
    def using(lib):
        real = build.lib
        build.lib = lambda name: lib if name == "viterbi" else real(name)
        try:
            yield
        finally:
            build.lib = real

    def timed():
        return {k: cuda_times(lambda a=a: vk.viterbi_stats(*a, *tabs), n)
                for k, (a, n) in shapes.items()}

    rec = {"viterbi": timed()}
    with using(variant_lib("fwd", cut_walk(args.split_at))):
        rec["viterbi_forward_only"] = timed()
    variants = [(f"lanes{k}", set_lanes(k)) for k in args.lanes]
    edits: dict = {}
    for e in args.edit:
        tag, rest = e.split(":", 1)
        pat, repl = rest.split("=>", 1)
        edits.setdefault(tag, []).append((pat, repl))
    variants += [(f"edit_{tag}", regex_edits(subs))
                 for tag, subs in edits.items()]
    head = tuple(t[:8].contiguous() for t in (X, Y, LX, LY))
    want = vk.viterbi_reference(*head, *tabs)
    for tag, edit in variants:
        lib = variant_lib(tag, edit)
        with using(lib):
            got = vk.viterbi_stats(*head, *tabs)
            rec[f"viterbi_{tag}"] = timed()
        rec[f"viterbi_{tag}"]["ptxas"] = lib.ptxas
        rec[f"viterbi_{tag}"]["bit_equal_b8"] = all(
            bool(torch.equal(a, w)) for a, w in zip(got, want))
    torch.cuda.synchronize()
    return rec


def align_runs(n: int) -> dict:
    """{path: {wall_s, stages_s, hashes}} of n runs of each end-to-end
    path on the smoke family, each path warmed by one run."""
    import torch

    from mlprobs_tpu_torch.align import aligner
    from mlprobs_tpu_torch.pipeline.driver import run_pipeline
    from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS
    from mlprobs_tpu_torch.utils.synth import synthetic_family

    records = synthetic_family(48, 330, 470, sub=0.5, indel=0.1, seed=48)

    def pipeline():
        return run_pipeline(records, device="cuda")[1].final_hash

    def base(strategy):
        return aligner.align_family(records, config="pnp", strategy=strategy,
                                    device="cuda").content_hash()

    os.environ["MLPROBS_MULTICHIP"] = "0"
    out = {}
    for path, exact, fn in (("align_qpx", None, pipeline),
                            ("align_qp_scaled", "0", pipeline),
                            ("base", None, lambda: base(0)),
                            ("base_p1", None, lambda: base(1))):
        if exact is None:
            os.environ.pop("MLPROBS_QP_EXACT", None)
        else:
            os.environ["MLPROBS_QP_EXACT"] = exact
        fn()
        got = {"wall_s": [], "stages_s": [], "hashes": set()}
        for _ in range(n):
            STATS.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got["hashes"].add(fn())
            torch.cuda.synchronize()
            got["wall_s"].append(time.perf_counter() - t0)
            got["stages_s"].append({k[5:]: v for k, v in
                                    STATS.to_dict().items()
                                    if k.startswith("time.")})
        got["median_wall_s"] = statistics.median(got["wall_s"])
        got["hashes"] = sorted(got["hashes"])
        out[path] = got
    os.environ.pop("MLPROBS_QP_EXACT", None)
    return out


if __name__ == "__main__":
    main()
