"""Command-line interface of the port.

    python -m mlprobs_tpu_torch.pipeline.cli align <in.fasta> <out.msa>
        [--device cuda|cpu] [-v]
    python -m mlprobs_tpu_torch.pipeline.cli base <in.fasta> <out.msa>
        [--config pnp|quickprobs] [-p 0|1] [--device cuda|cpu] [-v]

`align` runs the full MLProbs pipeline (the MLProbs.py role); `base` runs
the family aligner alone (the c_p_np_aln role with `--config pnp`,
progressive with `-p 0` and non-progressive with `-p 1`; the QuickProbs
role with `--config quickprobs`).  Both run on the card; pass `--device
cpu` for the plain PyTorch path.  `bench` is not ported yet.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_align(args) -> int:
    from mlprobs_tpu_torch.core.fasta import read_fasta, write_fasta
    from mlprobs_tpu_torch.pipeline.driver import run_pipeline

    records = read_fasta(args.input)
    t0 = time.time()
    out, rep = run_pipeline(records, verbose=args.verbose,
                            device=args.device)
    dt = time.time() - t0
    write_fasta(args.output, out.to_records(), width=0)
    if args.verbose:
        print(f"[ELAPSED TIME] Total Running time: {dt:.3f} sec.")
        print(json.dumps(rep.timings, default=float))
    return 0


def _cmd_base(args) -> int:
    from mlprobs_tpu_torch.align.aligner import align_family
    from mlprobs_tpu_torch.core.fasta import read_fasta, write_fasta
    from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS

    records = read_fasta(args.input)
    report: dict = {}
    t0 = time.time()
    out = align_family(records, config=args.config, strategy=args.strategy,
                       report=report, device=args.device)
    dt = time.time() - t0
    write_fasta(args.output, out.to_records())
    if args.verbose:
        print(f"[ELAPSED TIME] Total Running time: {dt:.3f} sec.")
        print(json.dumps({"report": report, "stats": STATS.to_dict()},
                         default=float))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mlprobs_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("align", help="full MLProbs pipeline")
    a.add_argument("input")
    a.add_argument("output")
    a.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a.add_argument("-v", "--verbose", action="store_true")
    a.set_defaults(fn=_cmd_align)

    b = sub.add_parser("base", help="family aligner only")
    b.add_argument("input")
    b.add_argument("output")
    b.add_argument("--config", default="pnp",
                   choices=["pnp", "quickprobs"])
    b.add_argument("-p", "--strategy", type=int, default=0,
                   choices=[0, 1],
                   help="0 = progressive, 1 = non-progressive")
    b.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    b.add_argument("-v", "--verbose", action="store_true")
    b.set_defaults(fn=_cmd_base)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
