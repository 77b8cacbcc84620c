"""Time the base aligner's merge (the progressive alignment and refinement
on the host: `stages_s.merge` of chip_smoke.py's [main]) of one checkout
of the port, for comparing two checkouts on one machine.

    python3 mlprobs_tpu_torch/utils/time_merge_ab.py --root DIR [--reps 3]

DIR is the root of the checkout whose `mlprobs_tpu_torch` runs; its
kernels and host library build there first, outside the timing.  The
smoke family (N = 48, 330-470 residues, seed 48) goes through
`align_family(config="pnp")` on the card once, and its merge
(`progressive.compute_final_alignment`) runs --reps times on copies of
the same inputs.  Run two checkouts one after the other, A B B A, and compare
only within such a run.  Prints one JSON line: the root, the card's name
and power limit, the host's cores and OpenMP threads, and each merge's
seconds and MSA hash.  Needs a CUDA card.
"""
import argparse
import copy
import json
import os
import subprocess
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_merge_ab: no CUDA card")
    from mlprobs_tpu_torch.align import aligner, progressive
    from mlprobs_tpu_torch.ops.kernels import build
    from mlprobs_tpu_torch.utils import host
    from mlprobs_tpu_torch.utils.synth import synthetic_family

    assert progressive.__file__.startswith(root), progressive.__file__
    build.build_all()
    host.lib()
    real = progressive.compute_final_alignment
    runs = []

    def timed(*a, **kw):
        out = None
        for _ in range(args.reps):
            # each merge from the same state (its GlibcRand included)
            a_, kw_ = copy.deepcopy((a, kw))
            t0 = time.perf_counter()
            out = real(*a_, **kw_)
            runs.append({"merge_s": time.perf_counter() - t0,
                         "hash": out.content_hash()})
        return out

    progressive.compute_final_alignment = timed
    records = synthetic_family(48, 330, 470, sub=0.5, indel=0.1, seed=48)
    msa = aligner.align_family(records, config="pnp", device="cuda")
    rec = {
        "root": root,
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        "cores": os.cpu_count(),
        "omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
        "merges": runs, "final_hash": msa.content_hash(),
    }
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
