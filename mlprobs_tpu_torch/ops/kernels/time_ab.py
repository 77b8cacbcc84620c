"""Time the CUDA kernels of one checkout of the port at the main path's
shape (Lp = 512, B = 256), for comparing two checkouts on one card.

    python3 mlprobs_tpu_torch/ops/kernels/time_ab.py --root DIR [--reps 21]
        [--align N]
    python3 mlprobs_tpu_torch/ops/kernels/time_ab.py --root DIR --viterbi
        [--split-at REGEX] [--lanes 1,2,8] [--edit TAG:REGEX=>TEXT]

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
