"""Command-line interface of the port.

    python -m mlprobs_tpu_torch.pipeline.cli align <in.fasta> <out.msa>
        [--device cuda|cpu] [-v]
    python -m mlprobs_tpu_torch.pipeline.cli base <in.fasta> <out.msa>
        [--config pnp|quickprobs] [-p 0|1] [--annot FILE] [--clustalw]
        [--autosave N] [--device cuda|cpu] [-v]
    python -m mlprobs_tpu_torch.pipeline.cli bench <suite-dir> [--out DIR]
        [--limit N] [--golden DIR] [--resume] [--family-timeout S]
        [--device cuda|cpu]

`align` runs the full MLProbs pipeline (the MLProbs.py role); `base` runs
the family aligner alone (the c_p_np_aln role with `--config pnp`,
progressive with `-p 0` and non-progressive with `-p 1`; the QuickProbs
role with `--config quickprobs`), with the reference's `-annot` column
scores, ClustalW output and refinement autosave; `bench` runs `align`
over a suite directory and scores each family's MSA against its golden
alignment (the script.py role).  All three run on the card; pass
`--device cpu` for the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path


@contextlib.contextmanager
def _span_records(verbose: bool):
    """The registry's span records of the block, kept only while
    `verbose` (-v)."""
    from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS

    records: list = []
    if verbose:
        STATS.add_sink(records.append)
    try:
        yield records
    finally:
        if verbose:
            STATS.remove_sink(records.append)


def _verbose_line(records: list, **fields) -> str:
    """-v's JSON line: `fields`, the span summary (per key: calls, total
    and self seconds, counters) and, on a card, the allocator's peak."""
    import torch

    from mlprobs_tpu_torch.utils.stats import summary

    line = dict(fields, spans=summary(records))
    if torch.cuda.is_available():
        line["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return json.dumps(line, default=float)


def _cmd_align(args) -> int:
    from mlprobs_tpu_torch.core.fasta import read_fasta, write_fasta
    from mlprobs_tpu_torch.pipeline.driver import run_pipeline

    records = read_fasta(args.input)
    t0 = time.time()
    with _span_records(args.verbose) as spans:
        out, rep = run_pipeline(records, verbose=args.verbose,
                                device=args.device)
    dt = time.time() - t0
    write_fasta(args.output, out.to_records(), width=0)
    if args.verbose:
        print(f"[ELAPSED TIME] Total Running time: {dt:.3f} sec.")
        print(_verbose_line(spans, timings=rep.timings))
    return 0


def _cmd_base(args) -> int:
    from mlprobs_tpu_torch.align.aligner import align_family
    from mlprobs_tpu_torch.core.fasta import read_fasta, write_fasta
    from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS

    records = read_fasta(args.input)
    observer = None
    if args.autosave:
        # ExtendedMSA::iterationDone autosave (ExtendedMSA.cpp:228-236)
        def observer(alignment, iteration):
            if iteration % args.autosave == 0:
                write_fasta(f"{args.output}_r{iteration}",
                            alignment.to_records(), width=0)

    keep: dict = {}
    report: dict = {}
    t0 = time.time()
    with _span_records(args.verbose) as spans:
        out = align_family(records, config=args.config,
                           strategy=args.strategy, report=report,
                           observer=observer,
                           keep=keep if args.annot else None,
                           device=args.device)
    dt = time.time() - t0
    if args.annot:
        # per-column 0-200 reliability scores (-annot, MSA.cpp:2142-2206)
        from mlprobs_tpu_torch.pipeline.auxtools import annotation_scores

        scores = annotation_scores(out.sort_by_label(),
                                   keep.get("posts", {}))
        Path(args.annot).write_text("".join(f"{s:4d}\n" for s in scores))
    if args.clustalw:
        from mlprobs_tpu_torch.pipeline.auxtools import write_clustal

        Path(args.output).write_text(write_clustal(out))
    else:
        write_fasta(args.output, out.to_records())
    if args.verbose:
        print(f"[ELAPSED TIME] Total Running time: {dt:.3f} sec.")
        print(_verbose_line(spans, report=report, stats=STATS.to_dict()))
    return 0


def _cmd_bench(args) -> int:
    import signal

    from mlprobs_tpu_torch.bench.quality import sp_tc
    from mlprobs_tpu_torch.core.fasta import read_fasta, write_fasta
    from mlprobs_tpu_torch.core.msa import MSA
    from mlprobs_tpu_torch.pipeline.driver import run_pipeline
    from mlprobs_tpu_torch.utils import device as devlib

    devlib.resolve(args.device)
    suite = Path(args.suite)
    indir = suite / "in" if (suite / "in").is_dir() else suite
    golden_dir = None
    if args.golden:
        golden_dir = Path(args.golden)
    else:
        cand = Path(str(suite).replace("TEST", "output4evaluation"))
        if cand.is_dir():
            golden_dir = cand
    files = sorted(indir.iterdir())
    if args.limit:
        files = files[: args.limit]
    outdir = Path(args.out) if args.out else None
    if outdir:
        outdir.mkdir(parents=True, exist_ok=True)
    if args.resume and outdir:
        # suite runs are resumable by inspection, like the reference's
        # staged tmp layout (SURVEY §5.4)
        files = [f for f in files if not (outdir / f.name).exists()]

    def _alarm(signum, frame):
        raise TimeoutError

    times, sps, tcs = [], [], []
    for f in files:
        t0 = time.time()
        if args.family_timeout:
            # a wedged family would stall the whole suite; die loudly so
            # that an outer wrapper can restart with --resume
            signal.signal(signal.SIGALRM, _alarm)
            signal.alarm(args.family_timeout)
        try:
            out, rep = run_pipeline(read_fasta(f), device=args.device)
        except TimeoutError:
            print(f"TIMEOUT: family {f.name} exceeded timeout", flush=True)
            return 3
        finally:
            if args.family_timeout:
                signal.alarm(0)
        dt = time.time() - t0
        times.append(dt)
        if outdir:
            write_fasta(outdir / f.name, out.to_records(), width=0)
        line = (f"{f.name}: {dt:.2f}s n={rep.num_seqs} "
                f"strat={rep.strategy} mode={rep.realign_mode}")
        if golden_dir and (golden_dir / f.name).exists():
            try:
                ref = MSA.from_records(read_fasta(golden_dir / f.name))
                sp, tc = sp_tc(out, ref)
                sps.append(sp)
                tcs.append(tc)
                line += f" sp={sp:.3f} tc={tc:.3f}"
            except Exception as e:  # scoring must never kill the run
                line += f" score_err={type(e).__name__}"
        print(line, flush=True)
    if times:
        summary = {
            "families": len(times),
            "mean_sec_per_family": sum(times) / len(times),
        }
        if sps:
            summary["mean_sp_vs_golden"] = sum(sps) / len(sps)
            summary["mean_tc_vs_golden"] = sum(tcs) / len(tcs)
        print(json.dumps(summary))
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
    b.add_argument("--clustalw", action="store_true",
                   help="write ClustalW .aln output")
    b.add_argument("--autosave", type=int, default=0,
                   help="autosave refinement every N iterations to "
                        "<output>_r<iter> (0 = off)")
    b.add_argument("--annot", default=None,
                   help="write per-column 0-200 reliability scores "
                        "to this file (-annot role)")
    b.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    b.add_argument("-v", "--verbose", action="store_true")
    b.set_defaults(fn=_cmd_base)

    c = sub.add_parser("bench", help="run a benchmark suite")
    c.add_argument("suite")
    c.add_argument("--out", default=None)
    c.add_argument("--limit", type=int, default=0)
    c.add_argument("--golden", default=None,
                   help="directory of reference MSAs to score against")
    c.add_argument("--resume", action="store_true",
                   help="skip families whose output already exists")
    c.add_argument("--family-timeout", type=int, default=0,
                   help="abort (exit 3) if one family exceeds this many "
                        "seconds; combine with --resume in a retry loop")
    c.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    c.set_defaults(fn=_cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
