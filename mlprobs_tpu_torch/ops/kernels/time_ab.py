"""Time the CUDA sweep and combine of one checkout of the port at the main
path's shape (three models, Lp = 512, B = 256), for comparing two
checkouts on one card.

    python3 mlprobs_tpu_torch/ops/kernels/time_ab.py --root DIR [--reps 21]

DIR is the root of the checkout whose `mlprobs_tpu_torch` is timed (its
kernels build there on first use).  Run two checkouts on one card, one
after the other, A B B A, and compare medians only within such a run.
Prints one JSON line: the root, the card's name and power limit, and the
median and every time in milliseconds of the forward sweep and of the
dense combine, from CUDA events.  Needs a CUDA card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--lp", type=int, default=512)
    ap.add_argument("--batch", type=int, default=256)
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

    def times(fn):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(args.reps):
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
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
