"""All-pairs posterior stage: pair batches through the wavefront kernels.

The reference runs an OpenMP loop over the N(N-1)/2 pairs
(MSA.cpp:926-1013); here pairs are padded into (batch, Lp) buckets and
each batch runs the two CUDA kernels (`ops/kernels/wavefront_kernel.py`)
on the card, or their plain PyTorch versions when the caller asks for the
CPU.

Model selection per family identity class (pdoAlign, MSA.cpp:941-1010):
  pid <= 1 : RMS combine of double-affine HMM, partition-function and
             local posteriors  sqrt((v1^2+v2^2+v3^2)/3)
  pid == 2 : local model only
  pid >= 3 : partition function only

Mode "qp" is the QuickProbs-role realigner's posterior: the qpx hmm5
posterior (ops/qpx.py, the reference's f32 log-space arithmetic) and the
sweep kernel's partition posterior on the Vtml200 tables, filtered to
[0.001, 1], RMS-combined (PosteriorStage.cpp:123-196).
"""
from __future__ import annotations

import functools
from typing import Iterator, Sequence

import numpy as np
import torch

from mlprobs_tpu_torch.core.config import DEFAULT as _CFG
from mlprobs_tpu_torch.core.config import engine_budgets
from mlprobs_tpu_torch.models import params as mp
from mlprobs_tpu_torch.ops import qpx, wavefront
from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as wk
from mlprobs_tpu_torch.utils import device as devlib

LEN_BUCKET = _CFG.engine.length_bucket
TOPK = _CFG.engine.topk_per_row
CUTOFF = _CFG.aligner.posterior_cutoff   # SparseMatrix.h:14
EXTRACT_TOPK = _CFG.engine.extract_topk
# the Viterbi feature pass's initial distribution (ops/viterbi.py VIT_INIT)
VIT_INIT = np.log(np.array([0.6080327034, 0.1959836632, 0.1959836632],
                           dtype=np.float64)).astype(np.float32)

_MODE_MODELS = {
    "mix": ("hmm5", "partition", "local"),
    "qp": ("hmm5", "partition"),
    "hmm5": ("hmm5",),
    "local": ("local",),
    "partition": ("partition",),
}


def _bucket_len(n: int) -> int:
    return max(LEN_BUCKET, -(-n // LEN_BUCKET) * LEN_BUCKET)


def _wf_batch_size(lp: int, device: torch.device) -> int:
    """Pairs per batch: the device's plane budget over ~80 bytes per
    (pair, cell) — fwd and rev planes of three models, the combined
    plane and its unskewed copy — as a power of two, at most
    `max_batch`, down to 1 for a pair whose planes fill the budget."""
    budget = engine_budgets(device.type, device.index)[0]
    cap = max(1, budget // (80 * lp * lp))
    cap = 1 << (cap.bit_length() - 1)
    return int(min(cap, _CFG.engine.max_batch))


def _wf_tables(mode: str, leave_prob: float | None, device):
    """(tabs_f, tabs_r) probability tables of the mode's models."""
    tabs_f, tabs_r = mp.tables_from_numpy(
        *mp.log_tables(mode, leave_prob), device=device
    )
    models = _MODE_MODELS[mode]
    return ({m: tabs_f[m] for m in models}, {m: tabs_r[m] for m in models})


def _pad_to(seq: np.ndarray, lp: int) -> np.ndarray:
    out = np.full(lp, 20, dtype=np.int8)
    out[: len(seq)] = seq
    return out


def iter_pair_batches(
    seqs: Sequence[np.ndarray], pairs: Sequence[tuple[int, int]],
    device: torch.device, force_lp: int | None = None,
) -> Iterator[tuple[list[tuple[int, int]], torch.Tensor, torch.Tensor,
                    torch.Tensor, torch.Tensor]]:
    """Yield (pair_chunk, X, Y, LX, LY) padded batches on `device`.

    Pairs are grouped by their own 128-lane length bucket (the
    reference's per-task wave sizing, PosteriorTasksWave.cpp:14-71);
    `force_lp` pins every pair to one bucket for consumers that build a
    uniform dense tensor.  The batch size comes from the device's
    budget; the kernels take any batch, so the last batch of a bucket is
    not padded with dummy pairs.
    """
    if not pairs:
        return
    lens = [len(s) for s in seqs]
    buckets: dict[int, list[tuple[int, int]]] = {}
    for i, j in pairs:
        lp = (force_lp if force_lp is not None
              else _bucket_len(max(lens[i], lens[j])))
        buckets.setdefault(lp, []).append((i, j))
    for lp in sorted(buckets):
        group = buckets[lp]
        bs = _wf_batch_size(lp, device)
        padded: dict[int, np.ndarray] = {}

        def pad(k: int) -> np.ndarray:
            if k not in padded:
                padded[k] = _pad_to(seqs[k][:lp], lp)
            return padded[k]

        for start in range(0, len(group), bs):
            chunk = group[start : start + bs]
            X = np.stack([pad(i) for i, _ in chunk])
            Y = np.stack([pad(j) for _, j in chunk])
            LX = np.array([lens[i] for i, _ in chunk], dtype=np.int32)
            LY = np.array([lens[j] for _, j in chunk], dtype=np.int32)
            yield chunk, *(torch.from_numpy(a).to(device)
                           for a in (X, Y, LX, LY))


def _wf_fn(models: tuple[str, ...], with_matches: bool):
    """Posterior stage of one batch with the per-diagonal top-k fused
    into combine: (vals (D, B, k), lanes, score[, nb])."""

    def run(X, Y, LX, LY, tabs_f, tabs_r):
        return wk.posterior(
            X, Y, LX, LY, tabs_f, tabs_r, models=models,
            with_matches=with_matches, topk=TOPK, cutoff=CUTOFF,
        )

    return run


def _wf_dense_fn(models: tuple[str, ...]):
    """Posterior stage of one batch emitting grid-space dense planes
    (B, Lp, Lp), thresholded at the cutoff, and the MWT scores."""

    def run(X, Y, LX, LY, tabs_f, tabs_r):
        post, score = wk.posterior(
            X, Y, LX, LY, tabs_f, tabs_r, models=models,
            with_matches=False,
        )
        dense = wavefront.unskew_posterior(post)
        return torch.where(dense >= CUTOFF, dense, 0.0), score

    return run


@functools.lru_cache(maxsize=4)
def _qpx_params(device: torch.device) -> tuple:
    """(init, trans, lmatch, lins) of the hmm5 model, log f32 on device."""
    p5 = mp.hmm5_params()
    return tuple(torch.as_tensor(a, device=device)
                 for a in (p5.init, p5.trans, p5.lmatch, p5.lins))


def _qpx_combined_skew(X, Y, LX, LY, tabs_f, tabs_r):
    """(D, B, W) RMS-combined qp posterior with reference numerics: the
    qpx hmm5 posterior and the partition posterior of the two sweeps.

    The RMS runs in place on the partition plane, which keeps the batch's
    peak at the sweeps' two planes, the hmm5 posterior and the plain
    `posterior_skew`'s temporaries."""
    ph = qpx.hmm5_posterior_qpx(X, Y, LX, LY, *_qpx_params(X.device))
    fwd, rev = wk.sweeps(X, Y, LX, LY, tabs_f, tabs_r, ("partition",))
    pp = wavefront.posterior_skew(fwd, rev, "partition")
    del fwd, rev
    # the reference drops partition posteriors outside [0.001, 1]
    # before the RMS combine (PartitionFunction.cpp:264-270)
    pp.masked_fill_(~((pp >= 0.001) & (pp <= 1.0)), 0.0)
    pp.mul_(pp).add_(ph.mul_(ph))
    del ph
    return pp.mul_(0.5).sqrt_()


def _qp_exact_fn(with_matches: bool):
    """qp twin of _wf_fn: same (vals, lanes, score[, nb]) contract."""

    def run(X, Y, LX, LY, tabs_f, tabs_r):
        post = _qpx_combined_skew(X, Y, LX, LY, tabs_f, tabs_r)
        vals, lanes = wavefront.topk_skew(post, TOPK, CUTOFF)
        mw = wavefront.mwt_skew(post, LX, LY, with_matches=with_matches)
        return (vals, lanes) + (mw if with_matches else (mw,))

    return run


def _qp_exact_dense_fn():
    """qp twin of _wf_dense_fn: (dense grid plane, score)."""

    def run(X, Y, LX, LY, tabs_f, tabs_r):
        post = _qpx_combined_skew(X, Y, LX, LY, tabs_f, tabs_r)
        score = wavefront.mwt_skew(post, LX, LY, with_matches=False)
        dense = wavefront.unskew_posterior(post)
        return torch.where(dense >= CUTOFF, dense, 0.0), score

    return run


def topk_diag_to_csr(vals: np.ndarray, lanes: np.ndarray, li: int, lj: int):
    """CSR posterior from one pair's per-diagonal top-k (D, K) arrays.

    Skew cell (d, lane j) is grid cell (i, j) = (d - j, j), i.e. the
    0-based posterior entry (i - 1, j - 1).
    """
    import scipy.sparse as sp

    ds, ks = np.nonzero(vals > 0.0)
    j = lanes[ds, ks]
    r = ds - j - 1
    c = j - 1
    ok = (r >= 0) & (r < li) & (c >= 0) & (c < lj)
    return sp.csr_matrix(
        (vals[ds[ok], ks[ok]], (r[ok], c[ok])), shape=(li, lj)
    )


def topk_to_csr(vals: np.ndarray, idx: np.ndarray, li: int, lj: int):
    """Host-side CSR reconstruction of a device top-k sparse posterior."""
    import scipy.sparse as sp

    vals = vals[:li]
    idx = idx[:li]
    keep = vals > 0.0
    rows = np.repeat(np.arange(li), keep.sum(axis=1))
    cols = idx[keep]
    data = vals[keep]
    in_range = cols < lj
    return sp.csr_matrix(
        (data[in_range], (rows[in_range], cols[in_range])), shape=(li, lj)
    )


def _row_topk(planes: torch.Tensor, k: int):
    """Top k entries of every row, ties to the lowest column (stable
    descending sort: the JAX package's `lax.top_k` order)."""
    vals, idx = torch.sort(planes, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


class DevicePosteriorTensor:
    """Device-resident all-pairs posterior tensor + MWT distances.

    Posterior planes stay on the device as a dense zero-diagonal
    (N, N, Lp, Lp) tensor; the consistency relaxation runs as one einsum
    per round (MSA.cpp:1172-1360 / ConsistencyStage.cpp:133-259), and
    only the final sparse top-k extraction crosses to the host.  The
    full cutoff-thresholded posterior (not a top-k subset) goes through
    the relaxation (SparseMatrix.h:14).
    """

    def __init__(self, S, pairs, dist, seq_lens):
        self.S = S                  # (N, N, Lp, Lp) tensor, zero diagonal
        self.pairs = pairs
        self.dist = dist            # (N, N) np
        self.seq_lens = seq_lens

    def _extract(self, S) -> dict:
        """Top-k extract the pair planes to host CSRs (the only
        device -> host crossing of the consistency path)."""
        dev = S.device
        ii = torch.tensor([i for i, _ in self.pairs], device=dev)
        jj = torch.tensor([j for _, j in self.pairs], device=dev)
        vals, idx = _row_topk(S[ii, jj], EXTRACT_TOPK)
        vals = vals.cpu().numpy()
        idx = idx.cpu().numpy()
        posts = {}
        for k, (i, j) in enumerate(self.pairs):
            li, lj = self.seq_lens[i], self.seq_lens[j]
            posts[(i, j)] = topk_to_csr(vals[k], idx[k], li, lj)
        return posts

    def extract_csrs(self) -> dict:
        """Host CSRs of the unrelaxed posteriors."""
        return self._extract(self.S)

    def relax_and_extract(
        self,
        weights: np.ndarray | None = None,
        selfweight: float = 3.0,
        selectivity: float = 200.0,
        reps: int = 2,
        final_cutoff: float | None = None,
    ) -> dict:
        """`reps` relaxation rounds on the device, host CSRs: baseMSA's
        without `weights`, QuickProbs' weighted accept-all with them."""
        from mlprobs_tpu_torch.align import consistency as cons

        n = self.S.shape[0]
        dev = self.S.device
        sc, zs, w = (torch.from_numpy(a).to(dev)
                     for a in cons.dense_relax_coeffs(
                         n, weights, selfweight=selfweight,
                         selectivity=selectivity))
        S = cons.relax_dense_rounds(self.S, sc, zs, w, reps=reps,
                                    final_cutoff=final_cutoff)
        return self._extract(S)


def tensor_bytes_over_budget(seqs: Sequence[np.ndarray], device) -> int:
    """The dense tensor's bytes for a family of three or more sequences
    when they exceed the device's tensor budget, else 0."""
    device = devlib.resolve(device)
    n = len(seqs)
    if n < 3:
        return 0
    lp = _bucket_len(max(len(s) for s in seqs))
    nbytes = n * n * lp * lp * 4
    budget = engine_budgets(device.type, device.index)[1]
    return nbytes if nbytes > budget else 0


def device_posterior_tensor(
    seqs: Sequence[np.ndarray],
    mode: str,
    leave_prob: float | None = None,
    report: dict | None = None,
    device="cuda",
) -> DevicePosteriorTensor | None:
    """Build the device posterior tensor, or None when the family is too
    small or the tensor is over the device's budget.

    A None return downgrades the consistency stage to the host path;
    `report` records why — downgrades are never silent (SURVEY §5.5).
    """
    device = devlib.resolve(device)
    if report is None:
        report = {}
    n = len(seqs)
    if n < 3:
        report["consistency_downgrade"] = "tiny_family"
        return None
    over = tensor_bytes_over_budget(seqs, device)
    if over:
        report["consistency_downgrade"] = f"over_budget:{over >> 20}MiB"
        return None
    lp = _bucket_len(max(len(s) for s in seqs))

    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    tabs_f, tabs_r = _wf_tables(mode, leave_prob, device)
    fn = (_qp_exact_dense_fn() if mode == "qp"
          else _wf_dense_fn(_MODE_MODELS[mode]))
    S = torch.zeros((n, n, lp, lp), dtype=torch.float32, device=device)
    dist = np.zeros((n, n))
    for chunk, X, Y, LX, LY in iter_pair_batches(
        seqs, pairs, device, force_lp=lp
    ):
        dense, score = fn(X, Y, LX, LY, tabs_f, tabs_r)
        ii = torch.tensor([i for i, _ in chunk], device=device)
        jj = torch.tensor([j for _, j in chunk], device=device)
        S[ii, jj] = dense
        S[jj, ii] = dense.transpose(1, 2)
        sc = score.cpu().numpy()
        for k, (i, j) in enumerate(chunk):
            d = 1.0 - sc[k] / min(len(seqs[i]), len(seqs[j]))
            dist[i, j] = dist[j, i] = d
    return DevicePosteriorTensor(S, pairs, dist, [len(s) for s in seqs])


def all_pairs_posteriors(
    seqs: Sequence[np.ndarray],
    mode: str,
    leave_prob: float | None = None,
    pairs: Sequence[tuple[int, int]] | None = None,
    with_matches: bool = False,
    device="cuda",
) -> Iterator[tuple]:
    """Yield ((i, j), sparse posterior csr (li, lj), mwt_score[, n_matches])
    per pair.  A pair too long for a batch of several runs at B = 1 on
    the same device."""
    device = devlib.resolve(device)
    n = len(seqs)
    if pairs is None:
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    tabs_f, tabs_r = _wf_tables(mode, leave_prob, device)
    fn = (_qp_exact_fn(with_matches) if mode == "qp"
          else _wf_fn(_MODE_MODELS[mode], with_matches))
    for chunk, X, Y, LX, LY in iter_pair_batches(seqs, pairs, device):
        out = [o.cpu().numpy() for o in fn(X, Y, LX, LY, tabs_f, tabs_r)]
        vals, lanes, score = out[:3]
        for k, (i, j) in enumerate(chunk):
            li, lj = len(seqs[i]), len(seqs[j])
            csr = topk_diag_to_csr(vals[:, k], lanes[:, k], li, lj)
            if with_matches:
                yield (i, j), csr, float(score[k]), int(out[3][k])
            else:
                yield (i, j), csr, float(score[k])


def viterbi_stat_batches(
    seqs: Sequence[np.ndarray],
    pairs: Sequence[tuple[int, int]],
    blosum: np.ndarray,
    device="cuda",
) -> Iterator[tuple[list[tuple[int, int]], np.ndarray, np.ndarray,
                    np.ndarray]]:
    """Viterbi + traceback feature statistics on the device.

    Yields (pair_chunk, path_len (nb,), matches (nb,),
    scores_rev (2*Lp, nb)); the (D, B, W) direction planes never leave the
    device (they are consumed by wavefront.viterbi_path_stats).
    """
    device = devlib.resolve(device)
    _, lo, _ = mp.log_tables("mix", None)
    pl = {k: torch.as_tensor(np.asarray(lo[k], np.float32), device=device)
          for k in ("lmatch", "lins", "trans")}
    vinit = torch.as_tensor(VIT_INIT, device=device)
    bl = torch.as_tensor(np.asarray(blosum, np.float32), device=device)
    for chunk, X, Y, LX, LY in iter_pair_batches(seqs, pairs, device):
        dirs_s, ends, _ = wavefront.viterbi_wavefront(X, Y, LX, LY, pl, vinit)
        plen, matches, scores_rev = wavefront.viterbi_path_stats(
            dirs_s, ends, X, Y, LX, LY, bl
        )
        yield (chunk, plen.cpu().numpy(), matches.cpu().numpy(),
               scores_rev.cpu().numpy())
