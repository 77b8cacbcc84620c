"""Time the CUDA kernels of one checkout of the port at the main path's
shape (Lp = 512, B = 256), for comparing two checkouts on one card.

    python3 mlprobs_tpu_torch/ops/kernels/time_ab.py --root DIR [--reps 21]
        [--align N]

DIR is the root of the checkout whose `mlprobs_tpu_torch` is timed (its
kernels build there on first use).  Run two checkouts on one card, one
after the other, A B B A, and compare medians only within such a run.
Prints one JSON line: the root, the card's name and power limit, and the
median and every time in milliseconds, from CUDA events, of the forward
sweep and the dense combine (three models), of the qpx forward/backward,
and of one whole qp batch of the realigner (`_qp_exact_fn`: the
qpx posterior, the partition sweeps and posterior, the MWT and top-k;
at most 5 runs).  With --align N, also N runs of each end-to-end path on
the 48-sequence smoke family of `chip_smoke.py`, after one warm-up run
each: `cli align`'s pipeline (`run_pipeline`) on the default qpx route
and with MLPROBS_QP_EXACT=0, then `base` (`align_family`, pnp) and `base
-p 1`: wall seconds, the stage timers and the MSA's hash.  Needs a CUDA
card.
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
    g = torch.Generator().manual_seed(7)
    lx = torch.randint(lp // 2, lp + 1, (b,), generator=g)
    ly = torch.randint(lp // 2, lp + 1, (b,), generator=g)
    lx[0] = lp
    X = torch.full((b, lp), 20, dtype=torch.int8)
    Y = torch.full((b, lp), 20, dtype=torch.int8)
    for k in range(b):
        X[k, : lx[k]] = torch.randint(0, 20, (int(lx[k]),), generator=g)
        Y[k, : ly[k]] = torch.randint(0, 20, (int(ly[k]),), generator=g)
    X, Y = X.to(dev), Y.to(dev)
    LX, LY = lx.to(torch.int32).to(dev), ly.to(torch.int32).to(dev)
    zero = torch.zeros((b,), dtype=torch.int32, device=dev)
    tabs_f, tabs_r = pairwise._wf_tables("mix", 0.17, dev)
    fwd = wk.sweep(X, Y, zero, zero, LX, LY, tabs_f, models=models)
    rev = wk.sweep(X.flip(1).contiguous(), Y.flip(1).contiguous(),
                   (lp - LX).int(), (lp - LY).int(), LX, LY, tabs_r,
                   models=models, emit_pre=True)

    def times(fn, reps=args.reps):
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

    rec = {
        "root": root, "lp": lp, "batch": b, "models": list(models),
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        "sweep": times(lambda: wk.sweep(X, Y, zero, zero, LX, LY, tabs_f,
                                        models=models)),
        "combine": times(lambda: wk.combine(fwd, rev, LX, LY, models)),
    }
    del fwd, rev
    from mlprobs_tpu_torch.ops.kernels import qpx_kernel as qk

    p5 = pairwise._qpx_params(dev)
    rec["qpx"] = times(lambda: qk.hmm5_fb(X, Y, LX, LY, *p5))
    qtabs = pairwise._wf_tables("qp", None, dev)
    qp = pairwise._qp_exact_fn(False, lambda d: qtabs)
    rec["qp_batch"] = times(lambda: qp(X, Y, LX, LY), min(args.reps, 5))
    if args.align:
        del X, Y, LX, LY, zero, qp
        rec["align"] = align_runs(args.align)
    print(json.dumps(rec), flush=True)


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
