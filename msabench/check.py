"""The correctness check: the program's output against the plain reference.

Every family of the window must come back as a valid alignment of its
inputs (equal row lengths, each row degapped to its input) and without
run_pipeline's whole-family fallback after a fault.  A family drawn from
the seed before the window is aligned again, after the window, by the
plain reference (`msabench.msaref`, run through the same entry), and two
numbers are compared:

* `relax_gap`: what the window's consistency relaxation returned for
  that family (`DevicePosteriorTensor.relax_and_extract`, each call:
  the base aligner's, and the realigner's in `run_pipeline`) against the
  same relaxation worked out here in float64 from the reference's own
  posterior tensor, by a loop of matrix products over (i, z) that shares
  no code with the program's einsum: the norm of the difference over the
  norm of the float64 relaxation, on the entries that either side puts
  at or above `MARGIN`.  The float64 relaxation is worked out twice,
  every cutoff (the posterior tensor's and each round's) lowered and
  raised by `CUTOFF_TIE`, and each entry is read against the nearer of
  the two.
* `sp_gap`: the share of the reference MSA's aligned residue pairs that
  the program's MSA does not align (1 - SP, the bali_score sum-of-pairs
  of mlprobs_tpu_torch/bench/quality.py at commit 30598a0, copied here).

Each number has its limit in `limits/<cell>.json`, set between the sound
runs' readings and the control's (`CONTROLS`, the configuration's
`control`); PERF.md gives the readings.

The reference runs msaref with its four loops over diagonals replayed
(`routes/graph_replay.py`): the same operations on the same shapes, so
every value comes out as msaref's own loops give it, bit for bit, in
fewer launches from the host.  `plain=True` runs msaref's loops as they
are (`python3 -m msabench.control --route-check` compares the two).
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
# the control of each number: the reference in the program's place, in
# a lower precision than the configuration states (float32, TF32 off).
# relax_gap: the relaxation's contraction in TF32.  sp_gap: the whole
# family lowered, as an MSA moves only under a larger error: the
# contraction in TF32, the dense posterior planes stored in bfloat16 and
# the merge's profile-posterior planes rounded to bfloat16.
CONTROLS = {"relax_gap": "tf32_consistency", "sp_gap": "lower_precision"}
# entries of the relaxation compared: those that either side holds at or
# above twice the posterior cutoff (0.01), so that an entry rounding puts
# on one side of the cutoff and not the other is not read as a gap
MARGIN = 0.02
# what relax_gap reads when the calls do not match (a missing call, a
# missing pair): as far off as an answer can be
NO_MATCH = 1.0
# the posterior tensor keeps an entry where it is at or above the
# cutoff (0.01), and so does each round of the relaxation, which builds
# on what was kept: an entry within rounding of a cutoff is kept on one
# side and not on the other, and every entry of the relaxation that
# draws on it moves by a per cent or so (a posterior of float32(0.01)
# in the reference, one ulp less in the program: PERF.md).  The
# float64 relaxation is worked out from the posteriors and with the
# rounds' cutoffs all lowered by this share, and all raised by it, so
# that such an entry is kept in one and dropped in the other; the
# program is read against the nearer.  The program's and the
# reference's posteriors differ by 1e-7 of a value (the median, and the
# tie seen); a wider share puts more entries on both sides at once
CUTOFF_TIE = 1e-5


def degapped_ok(inputs, aligned) -> bool:
    """Equal row lengths, the same headers, and each row without its
    gaps equal to its input sequence."""
    rows = dict(aligned)
    return (len(rows) == len(inputs) == len(aligned)
            and len({len(s) for _, s in aligned}) == 1
            and all(rows.get(h, "").replace("-", "") == s
                    for h, s in inputs))


def _columns(records) -> dict:
    """header -> the column of each of its residues."""
    return {h: np.flatnonzero(np.frombuffer(s.encode(), np.uint8)
                              != ord("-"))
            for h, s in records}


def sp_gap(test, ref) -> float:
    """1 - SP of `test` scored against `ref` (records of the same
    sequences): the share of residue pairs aligned in a column of `ref`
    that `test` does not put in one column."""
    tcols, rcols = _columns(test), _columns(ref)
    headers = [h for h, _ in ref if h in tcols]
    if len(headers) < 2:
        return 0.0
    members: dict[int, list] = {}
    for si, h in enumerate(headers):
        for r, col in enumerate(rcols[h]):
            members.setdefault(int(col), []).append((si, r))
    tpos = [tcols[h] for h in headers]
    total = hit = 0
    for mem in members.values():
        if len(mem) < 2:
            continue
        got = np.array([tpos[si][r] for si, r in mem])
        _, counts = np.unique(got, return_counts=True)
        total += len(mem) * (len(mem) - 1) // 2
        hit += int((counts * (counts - 1) // 2).sum())
    return 1.0 - hit / total if total else 0.0


def limits(cell: str) -> dict:
    """{number: limit} of a cell."""
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())[
        "limits"]


# ---- the relaxation in float64 -------------------------------------------

def relax_coeffs64(n: int, weights=None, selfweight: float = 3.0,
                   selectivity: float = 200.0):
    """(self coefficient (N, N), z scale (N, N), z weights (N,)) in
    float64: MSAProbs' baseMSA relaxation (2/N, 1/N, 1) without
    `weights`, QuickProbs' weighted accept-all with them
    (w_ij = (1 + (sw - 1)(N - 2)/sel)(w_i + w_j),
    sumW = 1 + (sum(w) - w_i - w_j)/w_ij; self 1/sumW, z 1/(w_ij sumW))."""
    if weights is None:
        return (np.full((n, n), 2.0 / n), np.full((n, n), 1.0 / n),
                np.ones(n))
    w = np.asarray(weights, np.float64)
    wi = w[:, None] + w[None, :]
    wij = (1.0 + (selfweight - 1.0) * (n - 2) / selectivity) * wi
    sum_w = 1.0 + (w.sum() - wi) / wij
    return 1.0 / sum_w, 1.0 / (wij * sum_w), w


def relax64(S, weights=None, selfweight: float = 3.0,
            selectivity: float = 200.0, reps: int = 2,
            cutoff: float = 0.01, final_cutoff: float | None = None):
    """`reps` rounds of R_ij = self_ij S_ij + z_ij sum_z w_z S_iz S_zj on
    the zero-diagonal (N, N, Lp, Lp) posterior tensor `S`, in float64,
    one matrix product per (i, z); each round keeps R where S > 0 and
    R >= the round's cutoff (the last round's `final_cutoff` when given).
    Returns the float64 tensor."""
    import torch

    n = S.shape[0]
    sc, zs, w = relax_coeffs64(n, weights, selfweight, selectivity)
    S = S.to(torch.float64)
    for it in range(reps):
        c = (final_cutoff if final_cutoff is not None and it == reps - 1
             else cutoff)
        out = torch.empty_like(S)
        for i in range(n):
            acc = torch.zeros_like(S[i])
            for z in range(n):
                if z != i and w[z] != 0.0:
                    acc.add_(torch.matmul(S[i, z], S[z]), alpha=float(w[z]))
            r = (torch.as_tensor(sc[i], device=S.device)[:, None, None]
                 * S[i]
                 + torch.as_tensor(zs[i], device=S.device)[:, None, None]
                 * acc)
            out[i] = torch.where((S[i] > 0) & (r >= c), r, 0.0)
            del acc, r
        S = out
        del out
    return S


def topk_entries(S, pairs, seq_lens, k: int, block: int = 64) -> dict:
    """{(i, j): (rows, cols, values)} of each pair's plane: the `k`
    largest entries of every row (ties to the lower column), those above
    0 and inside the pair's true lengths."""
    import torch

    out = {}
    for b in range(0, len(pairs), block):
        chunk = pairs[b:b + block]
        ii = torch.tensor([i for i, _ in chunk], device=S.device)
        jj = torch.tensor([j for _, j in chunk], device=S.device)
        vals, idx = torch.sort(S[ii, jj], dim=-1, descending=True,
                               stable=True)
        vals = vals[..., :k].double().cpu().numpy()
        idx = idx[..., :k].cpu().numpy()
        for m, (i, j) in enumerate(chunk):
            li, lj = seq_lens[i], seq_lens[j]
            v, c = vals[m, :li], idx[m, :li]
            keep = (v > 0.0) & (c < lj)
            rows = np.nonzero(keep)[0]
            out[(i, j)] = (rows, c[keep], v[keep])
    return out


def _csr_entries(m) -> tuple:
    coo = m.tocoo()
    return coo.row, coo.col, coo.data.astype(np.float64)


def relax_gap(test: list, ref: list, alt: list | None = None,
              margin: float = MARGIN) -> float:
    """The largest, over the relaxation calls, of |test - ref| / |ref|
    (Frobenius norms over every pair of the call) on the entries that
    any side holds at or above `margin`, each entry of `test` read
    against the nearer of `ref` and `alt` (the float64 relaxation with
    its cutoffs lowered and raised by CUTOFF_TIE; `alt` None: `ref`
    alone).  `test`: per call {pair: scipy CSR} (the program's output)
    or {pair: (rows, cols, values)}; `ref`, `alt`: per call {pair:
    (rows, cols, values)}.  NO_MATCH where the calls or their pairs
    differ."""
    if alt is None:
        alt = ref
    if len(test) != len(ref) or len(alt) != len(ref) or not ref:
        return NO_MATCH
    worst = 0.0
    for t_call, r_call, h_call in zip(test, ref, alt):
        if set(t_call) != set(r_call) or set(h_call) != set(r_call):
            return NO_MATCH
        num = den = 0.0
        for key, (rr, rc, rv) in r_call.items():
            t = t_call[key]
            tr, tc, tv = t if isinstance(t, tuple) else _csr_entries(t)
            hr, hc, hv = h_call[key]
            width = int(max(tc.max(initial=0), rc.max(initial=0),
                            hc.max(initial=0))) + 1
            tk = tr.astype(np.int64) * width + tc
            rk = rr.astype(np.int64) * width + rc
            hk = hr.astype(np.int64) * width + hc
            keys = np.union1d(np.union1d(tk, rk), hk)
            a = np.zeros(len(keys))
            b = np.zeros(len(keys))
            h = np.zeros(len(keys))
            a[np.searchsorted(keys, tk)] = tv
            b[np.searchsorted(keys, rk)] = rv
            h[np.searchsorted(keys, hk)] = hv
            on = np.maximum(np.maximum(a, b), h) >= margin
            num += float(np.minimum((a[on] - b[on]) ** 2,
                                    (a[on] - h[on]) ** 2).sum())
            den += float((b[on] ** 2).sum())
        if den == 0.0:
            gap = 0.0 if num == 0.0 else NO_MATCH
        else:
            gap = math.sqrt(num / den)
        worst = max(worst, gap)
    return worst


class RelaxRecorder:
    """Keeps what the program's `DevicePosteriorTensor.relax_and_extract`
    returns while `armed`: one {pair: CSR} a call, in call order."""

    def __init__(self):
        self.armed = False
        self.calls: list = []
        self._saved = None

    def __enter__(self):
        from mlprobs_tpu_torch.align import pairwise

        owner = pairwise.DevicePosteriorTensor
        fn = owner.relax_and_extract
        self._saved = (owner, fn)
        rec = self

        def recorded(tensor, *a, **k):
            out = fn(tensor, *a, **k)
            if rec.armed:
                rec.calls.append(dict(out))
            return out
        owner.relax_and_extract = recorded
        return self

    def __exit__(self, *exc):
        owner, fn = self._saved
        owner.relax_and_extract = fn
        return False


class _Stop(Exception):
    """Ends a reference run once the relaxations asked for are read."""


@dataclass
class Reference:
    records: list | None            # the MSA; None when stopped early
    relax: list = field(default_factory=list)          # float64, a call
    relax_hi: list = field(default_factory=list)       # cutoffs raised
    relax_f32: list = field(default_factory=list)      # the reference's
    relax_control: list = field(default_factory=list)  # TF32 control


def reference(traffic: dict, records, device, sp_control: bool = False,
              relax_control: bool = False, stop_after: int | None = None,
              plain: bool = False) -> Reference:
    """The plain reference through the traffic's entry on `records`: its
    MSA, and for each relaxation call the float64 relaxation of the
    reference's own posterior tensor (top-k entries as the program
    extracts them), every cutoff lowered by CUTOFF_TIE (`relax`) and
    raised by it (`relax_hi`); the reference's own relaxation and MSA
    see the tensor at its cutoff.  `sp_control`: the whole run in the
    lower precision of CONTROLS["sp_gap"] (then no relaxation is read).
    `relax_control`: each call's relaxation also by the reference's own
    code in float32 and in TF32 (CONTROLS["relax_gap"]).  `stop_after`:
    end the run after that many relaxation calls (no MSA).  `plain`:
    msaref's own loops over diagonals in place of the replayed route's."""
    import torch

    from msabench.msaref.align import consistency, pairwise
    from msabench.msaref.align.aligner import align_family
    from msabench.msaref.pipeline.driver import run_pipeline
    from msabench.msaref.utils import host
    from msabench.routes import graph_replay

    out = Reference(None)
    owner = pairwise.DevicePosteriorTensor
    orig = owner.relax_and_extract
    orig_extract = owner.extract_csrs
    dense_fns = {k: getattr(pairwise, k)
                 for k in ("_wf_dense_fn", "_qp_exact_dense_fn")}
    cut = pairwise.CUTOFF

    def lowered(make):
        """A dense posterior builder whose planes keep what lies at or
        above the posterior cutoff lowered by CUTOFF_TIE."""
        def made(*a, **k):
            run = make(*a, **k)

            def ran(*args):
                pairwise.CUTOFF = cut * (1.0 - CUTOFF_TIE)
                try:
                    return run(*args)
                finally:
                    pairwise.CUTOFF = cut
            return ran
        return made

    def at_cutoff(tensor):
        """The tensor as msaref builds it: posteriors at or above its
        cutoff."""
        tensor.S.masked_fill_(~(tensor.S >= cut), 0.0)

    def read(tensor, weights=None, selfweight=3.0, selectivity=200.0,
             reps=2, final_cutoff=None):
        kw = dict(weights=weights, selfweight=selfweight,
                  selectivity=selectivity, reps=reps,
                  final_cutoff=final_cutoff)
        if not sp_control:
            for into, f in ((out.relax, 1.0 - CUTOFF_TIE),
                            (out.relax_hi, 1.0 + CUTOFF_TIE)):
                S = (tensor.S if f < 1.0 else
                     torch.where(tensor.S >= cut * f, tensor.S, 0.0))
                R = relax64(S, cutoff=consistency.CUTOFF * f,
                            **{**kw, "final_cutoff": None if final_cutoff
                               is None else final_cutoff * f})
                into.append(topk_entries(R, tensor.pairs, tensor.seq_lens,
                                         pairwise.EXTRACT_TOPK))
                del R, S
            at_cutoff(tensor)
        if relax_control:
            for tf32, into in ((False, out.relax_f32),
                               (True, out.relax_control)):
                consistency.ALLOW_TF32 = tf32
                try:
                    into.append(orig(tensor, **kw))
                finally:
                    consistency.ALLOW_TF32 = False
        if stop_after is not None and len(out.relax) >= stop_after:
            raise _Stop
        return orig(tensor, **kw)

    consistency.ALLOW_TF32 = sp_control
    pairwise.POSTERIOR_DTYPE = torch.bfloat16 if sp_control else None
    host.PLANE_BF16 = sp_control
    owner.relax_and_extract = read
    if not sp_control:
        def extract(tensor):
            at_cutoff(tensor)
            return orig_extract(tensor)
        owner.extract_csrs = extract
        for k, make in dense_fns.items():
            setattr(pairwise, k, lowered(make))
    route = contextlib.nullcontext() if plain else graph_replay.install()
    try:
        with route:
            if traffic["entry"] == "run_pipeline":
                msa, _ = run_pipeline(records, device=device)
            else:
                msa = align_family(records, device=device,
                                   **traffic.get("entry_args", {}))
        out.records = msa.to_records()
        del msa
    except _Stop:
        pass
    finally:
        owner.relax_and_extract = orig
        owner.extract_csrs = orig_extract
        for k, make in dense_fns.items():
            setattr(pairwise, k, make)
        pairwise.CUTOFF = cut
        consistency.ALLOW_TF32 = False
        pairwise.POSTERIOR_DTYPE = None
        host.PLANE_BF16 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def reference_records(traffic: dict, records, device,
                      control: str | None = None) -> list:
    """The plain reference's MSA of `records` through the traffic's
    entry; with `control` (CONTROLS["sp_gap"]) in its lower precision."""
    if control not in (None, CONTROLS["sp_gap"]):
        raise ValueError(f"control {control!r}: None or "
                         f"{CONTROLS['sp_gap']!r}")
    return reference(traffic, records, device,
                     sp_control=control is not None).records
