"""python3 -m msabench.control --workload <cell> --seeds a,b,c
[--program] [--relax-only] [--sp-control] [--route-check]

The readings that the correctness limits are set from, at the cell's own
size.  For each seed, family 0 of the seed goes through the plain
reference, which works out each relaxation call in float64
(`check.relax64`), in float32 by its own code and in TF32, the
relax_gap control (`check.CONTROLS`): the control's relax_gap against
the float64 relaxation is the upper reading.  With --program the port
aligns the same family through the cell's entry, and its relax_gap
(and, unless --relax-only, its sp_gap against the reference's MSA) is
the lower reading.  --relax-only ends the reference after its first
relaxation call (the base aligner's), which skips its merge.
--sp-control also aligns the family by the sp_gap control (the whole
reference in the lower precision) and gives its sp_gap.
--route-check also runs the reference with msaref's own loops over
diagonals (`check.reference(plain=True)`) and gives whether the route's
run agrees with it bit for bit (`route_equal`): the relaxations' inputs
(a digest of each call's posterior tensor), their float64, float32 and
TF32 outputs, and the MSA.
One JSON line a seed on standard output.  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import sys
import time
import weakref

import numpy as np

from msabench import check, generator, harness


def _gap(test: list, ref) -> float:
    return check.relax_gap(test, ref.relax, ref.relax_hi)


def _per_call(test: list, ref) -> list:
    return [check.relax_gap([t], [r], [h])
            for t, r, h in zip(test, ref.relax, ref.relax_hi)]


@contextlib.contextmanager
def _input_digests():
    """A list that receives a digest of the posterior tensor each of
    msaref's relaxation calls is given, while the block runs."""
    from msabench.msaref.align import pairwise

    owner = pairwise.DevicePosteriorTensor
    fn = owner.relax_and_extract
    got: list = []
    seen = weakref.WeakSet()

    def digested(tensor, *a, **k):
        if tensor not in seen:    # once a call
            seen.add(tensor)
            got.append(hashlib.sha256(
                tensor.S.cpu().numpy().tobytes()).hexdigest())
        return fn(tensor, *a, **k)
    owner.relax_and_extract = digested
    try:
        yield got
    finally:
        owner.relax_and_extract = fn


def _same_calls(a: list, b: list) -> bool:
    """Two lists of relaxation calls ({pair: CSR or (rows, cols,
    values)}) hold the same entries to the last bit."""
    def arrays(m):
        return ((m.indptr, m.indices, m.data) if hasattr(m, "indptr")
                else m)
    return len(a) == len(b) and all(
        set(x) == set(y) and all(
            all(np.array_equal(u, v) for u, v in zip(arrays(x[k]),
                                                     arrays(y[k])))
            for k in x)
        for x, y in zip(a, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m msabench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--relax-only", action="store_true")
    ap.add_argument("--sp-control", action="store_true")
    ap.add_argument("--route-check", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
    wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    config = harness.load_json("configs", wl["config"])
    traffic = harness.load_json("traffic", wl["traffic"])
    harness.apply_env(traffic)
    go = harness.program_entry(traffic, args.device) if args.program \
        else None
    for seed in (int(s) for s in args.seeds.split(",")):
        recs = generator.family(config["family"], seed, 0)
        out = {"workload": args.workload, "seed": seed}
        aligned = None
        if go is not None:
            t = time.perf_counter()
            with check.RelaxRecorder() as rec:
                rec.armed = True
                msa, _ = go(recs)
            out["program_s"] = time.perf_counter() - t
            aligned = msa.to_records()
            del msa
            out["program_valid"] = check.degapped_ok(recs, aligned)
        stop = 1 if args.relax_only else None
        t = time.perf_counter()
        with (_input_digests() if args.route_check
              else contextlib.nullcontext([])) as digests:
            ref = check.reference(traffic, recs, args.device,
                                  relax_control=True, stop_after=stop)
        out["reference_s"] = time.perf_counter() - t
        if args.route_check:
            t = time.perf_counter()
            with _input_digests() as plain_digests:
                plain = check.reference(traffic, recs, args.device,
                                        relax_control=True,
                                        stop_after=stop, plain=True)
            out["plain_reference_s"] = time.perf_counter() - t
            out["route_equal"] = {
                "inputs": digests == plain_digests,
                "relax64": (_same_calls(ref.relax, plain.relax)
                            and _same_calls(ref.relax_hi, plain.relax_hi)),
                "relax_f32": _same_calls(ref.relax_f32, plain.relax_f32),
                "relax_tf32": _same_calls(ref.relax_control,
                                          plain.relax_control),
                "msa": ref.records == plain.records}
            del plain
        out["calls"] = len(ref.relax)
        if go is not None:
            prog = rec.calls[:len(ref.relax)]
            out["program_relax_gap"] = _gap(prog, ref)
            out["program_relax_gap_by_call"] = _per_call(prog, ref)
            if ref.records is not None:
                out["program_sp_gap"] = check.sp_gap(aligned, ref.records)
        out["reference_f32_relax_gap"] = _gap(ref.relax_f32, ref)
        out["control_relax_gap"] = _gap(ref.relax_control, ref)
        out["control_relax_gap_by_call"] = _per_call(ref.relax_control, ref)
        if args.sp_control and ref.records is not None:
            t = time.perf_counter()
            ctl = check.reference_records(traffic, recs, args.device,
                                          check.CONTROLS["sp_gap"])
            out["sp_control_s"] = time.perf_counter() - t
            out["control_sp_gap"] = check.sp_gap(ctl, ref.records)
        del ref
        print(json.dumps(out), flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
