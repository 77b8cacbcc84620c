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
posterior (the qpx kernels, ops/kernels/qpx_kernel.py, replaying the
reference's f32 log-space arithmetic of ops/qpx.py) and the sweep
kernel's partition posterior on the Vtml200 tables, filtered to
[0.001, 1], RMS-combined (PosteriorStage.cpp:123-196); its MWT and
top-k run on the combine kernel over that plane
(`wavefront_kernel.mwt_topk`).  With MLPROBS_QP_EXACT=0, as in the JAX
package, mode "qp" runs the two kernels on the hmm5 and Vtml200
partition models instead, with no filter.

MLPROBS_POSTERIOR_ENGINE selects the engine of the posteriors:
  "pallas" (the default) — the CUDA kernels, or their plain versions on
             the CPU;
  "scan"   — the row-scan models (ops/pairhmm.py, ops/partition.py) with
             the dense MWT fill (ops/mwt.py) and a per-row top-k: an
             independent formulation of the same posteriors, as the JAX
             package's "scan" engine.  The scans run in float64: in f32
             their log-space sums drift from the kernels' posteriors by
             more than rtol 2e-3 at a few hundred residues (the JAX
             package's f32 scans as well); in f64 they stay well inside
             it.  It builds no consistency tensor, so the consistency
             runs on the host.
The JAX package's "native" host engine is not ported (the posteriors run
on the card), and its "wavefront" engine is the CPU path of "pallas".

MLPROBS_MULTICHIP=1 shards the pair stages over a pairs mesh of every
visible card (parallel/mesh.py), as the JAX package shards them over a
TPU mesh: the features, the posteriors and the dense relaxation of the
"pallas" engine.  One process drives every device of the mesh (`_mesh`,
`_shard_pairs`); a pair's results do not depend on the mesh.  Unset or
"auto", nothing is sharded (see `_mesh`).
"""
from __future__ import annotations

import functools
import os
from typing import Iterator, Sequence

import numpy as np
import torch

from mlprobs_tpu_torch.core.config import DEFAULT as _CFG
from mlprobs_tpu_torch.core.config import engine_budgets
from mlprobs_tpu_torch.models import params as mp
from mlprobs_tpu_torch.ops import (mwt, pairhmm, partition, viterbi,
                                   wavefront)
from mlprobs_tpu_torch.ops.kernels import qpx_kernel as qk
from mlprobs_tpu_torch.ops.kernels import viterbi_kernel as vk
from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as wk
from mlprobs_tpu_torch.ops.viterbi import VIT_INIT
from mlprobs_tpu_torch.parallel.mesh import (PairsMesh, gather, pairs_mesh,
                                             split_pairs)
from mlprobs_tpu_torch.utils import device as devlib
from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS

LEN_BUCKET = _CFG.engine.length_bucket
TOPK = _CFG.engine.topk_per_row
CUTOFF = _CFG.aligner.posterior_cutoff   # SparseMatrix.h:14
EXTRACT_TOPK = _CFG.engine.extract_topk
ENGINES = ("pallas", "scan")

_MODE_MODELS = {
    "mix": ("hmm5", "partition", "local"),
    "qp": ("hmm5", "partition"),
    "hmm5": ("hmm5",),
    "local": ("local",),
    "partition": ("partition",),
}


def _engine() -> str:
    """The posterior engine MLPROBS_POSTERIOR_ENGINE names ("pallas" when
    unset); any other value raises."""
    env = os.environ.get("MLPROBS_POSTERIOR_ENGINE") or "pallas"
    if env not in ENGINES:
        raise ValueError(
            f"MLPROBS_POSTERIOR_ENGINE={env!r}: the port's posterior "
            f"engines are {ENGINES} (the CUDA kernels, the row-scan models)")
    return env


def _qp_exact() -> bool:
    """Mode "qp" on the qpx route (the QuickProbs binary's arithmetic,
    the default) unless MLPROBS_QP_EXACT=0, which takes it to the
    scaled-probability kernels, as the JAX package's `_qp_exact`."""
    return os.environ.get("MLPROBS_QP_EXACT", "1") != "0"


def _bucket_len(n: int) -> int:
    return max(LEN_BUCKET, -(-n // LEN_BUCKET) * LEN_BUCKET)


def _mesh(device="cuda") -> PairsMesh | None:
    """The pairs mesh of a run on `device`, or None unsharded.

    MLPROBS_MULTICHIP: "1" shards over every visible card when there are
    two or more and the run is on the card (None on the CPU and on one
    card); "0" disables sharding; "auto", the default, shards nowhere.
    The JAX package's "auto" shards on a TPU of several chips; a mesh of
    H100s driven from one process measured slower than one card
    (PERF.md), so here sharding waits to be asked for."""
    if os.environ.get("MLPROBS_MULTICHIP", "auto") != "1":
        return None
    if torch.device(device).type != "cuda" or torch.cuda.device_count() < 2:
        return None
    return pairs_mesh()


def _reset_engine_caches() -> None:
    """Clear the device-dependent caches (tests and the chip smoke run
    change the mesh at run time)."""
    _wf_tables.cache_clear()
    _qpx_params.cache_clear()


def _shard_pairs(body, tables, mesh: PairsMesh | None,
                 out_axes: tuple[int, ...]):
    """`run(X, Y, LX, LY)`: `body(X, Y, LX, LY, *tables(device))`, with
    the pair axis of the four inputs split over `mesh` when there is one.

    Each device runs `body` on its share with its own tables
    (`tables(device)`, built once a device); `out_axes[k]` names the pair
    axis of output k (0 for per-pair values, 1 for (D, B, ...) planes),
    along which the outputs are concatenated on the caller's device.
    Every shard is launched before any is read back.  Per-pair results
    are independent of the split: pure data parallelism, as the JAX
    package's shard_map."""

    def run(X, Y, LX, LY):
        if mesh is None:
            return body(X, Y, LX, LY, *tables(X.device))
        outs = [body(*shard, *tables(dev))
                for dev, shard in split_pairs((X, Y, LX, LY), mesh)]
        return gather(outs, out_axes, X.device)

    return run


def _wf_batch_size(lp: int, device: torch.device,
                   mesh: PairsMesh | None = None) -> int:
    """Pairs per batch: the device's plane budget over ~80 bytes per
    (pair, cell) — fwd and rev planes of three models, the combined
    plane and its unskewed copy — as a power of two, at most
    `max_batch`, down to 1 for a pair whose planes fill the budget.

    With a mesh, each entry's batch from its device's budget, shared
    among the entries that name that device, times the mesh size, so
    that the batch splits evenly: each card holds its own batch's planes
    (a mesh of four cards takes four cards' batches at once)."""

    def cap(dev, share=1):
        budget = engine_budgets(dev.type, dev.index)[0] // share
        c = max(1, budget // (80 * lp * lp))
        c = 1 << (c.bit_length() - 1)
        return int(min(c, _CFG.engine.max_batch))

    if mesh is None:
        return cap(device)
    return mesh.size * min(cap(d, mesh.devices.count(d))
                           for d in mesh.devices)


@functools.lru_cache(maxsize=16)
def _wf_tables(mode: str, leave_prob: float | None, device):
    """(tabs_f, tabs_r) probability tables of the mode's models, built
    once a device."""
    tabs_f, tabs_r = mp.tables_from_numpy(
        *mp.log_tables(mode, leave_prob), device=device
    )
    models = _MODE_MODELS[mode]
    return ({m: tabs_f[m] for m in models}, {m: tabs_r[m] for m in models})


def _param_dict(params, keys, device) -> dict:
    device = devlib.resolve(device)
    return {k: torch.as_tensor(np.asarray(getattr(params, k), np.float32),
                               device=device) for k in keys}


def hmm5_dict(device="cuda") -> dict:
    """The hmm5 model's log tables as f32 tensors, under the JAX
    package's keys (trans, init, lmatch, lins)."""
    return _param_dict(mp.hmm5_params(), ("trans", "init", "lmatch", "lins"),
                       device)


def local_dict(leave_prob: float | None = None, device="cuda") -> dict:
    """The local model's log tables (trans, lmatch, lins, log_stay)."""
    return _param_dict(mp.hmm_local_params(leave_prob),
                       ("trans", "lmatch", "lins", "log_stay"), device)


def partition_dict(device="cuda") -> dict:
    """The partition model's log tables (lscore, lgap_open, lgap_ext)."""
    return _param_dict(mp.partition_params(),
                       ("lscore", "lgap_open", "lgap_ext"), device)


def partition_qp_dict(device="cuda") -> dict:
    """QuickProbs partition model (Vtml200; Configuration.cpp:321-333)."""
    return _param_dict(mp.partition_params_qp(),
                       ("lscore", "lgap_open", "lgap_ext"), device)


def _pad_to(seq: np.ndarray, lp: int) -> np.ndarray:
    out = np.full(lp, 20, dtype=np.int8)
    out[: len(seq)] = seq
    return out


def iter_pair_batches(
    seqs: Sequence[np.ndarray], pairs: Sequence[tuple[int, int]],
    device: torch.device, force_lp: int | None = None,
    mesh: PairsMesh | None = None,
) -> Iterator[tuple[list[tuple[int, int]], torch.Tensor, torch.Tensor,
                    torch.Tensor, torch.Tensor]]:
    """Yield (pair_chunk, X, Y, LX, LY) padded batches on `device`.

    Pairs are grouped by their own 128-lane length bucket (the
    reference's per-task wave sizing, PosteriorTasksWave.cpp:14-71);
    `force_lp` pins every pair to one bucket for consumers that build a
    uniform dense tensor.  The batch size comes from the device's
    budget (from every mesh device's with a mesh); the kernels take any
    batch, so the last batch of a bucket is not padded with dummy pairs.
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
        bs = _wf_batch_size(lp, device, mesh)
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


def _wf_fn(models: tuple[str, ...], with_matches: bool, tables,
           mesh: PairsMesh | None = None):
    """Posterior stage of one batch with the per-diagonal top-k fused
    into combine: (vals (D, B, k), lanes, score[, nb]); `tables(device)`
    gives a device's (tabs_f, tabs_r); with a mesh, each device runs its
    share of the batch."""

    def run(X, Y, LX, LY, tabs_f, tabs_r):
        return wk.posterior(
            X, Y, LX, LY, tabs_f, tabs_r, models=models,
            with_matches=with_matches, topk=TOPK, cutoff=CUTOFF,
        )

    return _shard_pairs(run, tables, mesh, (1, 1, 0, 0) if with_matches
                        else (1, 1, 0))


def _wf_dense_fn(models: tuple[str, ...], tables,
                 mesh: PairsMesh | None = None):
    """Posterior stage of one batch emitting grid-space dense planes
    (B, Lp, Lp), thresholded at the cutoff, and the MWT scores."""

    def run(X, Y, LX, LY, tabs_f, tabs_r):
        post, score = wk.posterior(
            X, Y, LX, LY, tabs_f, tabs_r, models=models,
            with_matches=False,
        )
        dense = wavefront.unskew_posterior(post)
        return torch.where(dense >= CUTOFF, dense, 0.0), score

    return _shard_pairs(run, tables, mesh, (0, 0))


@functools.lru_cache(maxsize=4)
def _qpx_params(device: torch.device) -> tuple:
    """(init, trans, lmatch, lins) of the hmm5 model, log f32 on device."""
    p5 = mp.hmm5_params()
    return tuple(torch.as_tensor(a, device=device)
                 for a in (p5.init, p5.trans, p5.lmatch, p5.lins))


def _qpx_combined_skew(X, Y, LX, LY, tabs_f, tabs_r):
    """(D, B, W) RMS-combined qp posterior with reference numerics: the
    qpx hmm5 posterior (the qpx kernels' planes) and the partition
    posterior of the two sweeps.

    The RMS runs in place on the partition plane, which keeps the batch's
    peak at the sweeps' two planes, the hmm5 posterior and the plain
    `posterior_skew`'s temporaries."""
    ph = qk.hmm5_posterior(X, Y, LX, LY, *_qpx_params(X.device))
    fwd, rev = wk.sweeps(X, Y, LX, LY, tabs_f, tabs_r, ("partition",))
    pp = wavefront.posterior_skew(fwd, rev, "partition")
    del fwd, rev
    # the reference drops partition posteriors outside [0.001, 1]
    # before the RMS combine (PartitionFunction.cpp:264-270)
    pp.masked_fill_(~((pp >= 0.001) & (pp <= 1.0)), 0.0)
    pp.mul_(pp).add_(ph.mul_(ph))
    del ph
    return pp.mul_(0.5).sqrt_()


_SCAN_MODELS = {
    "hmm5": pairhmm.hmm5_posterior,
    "local": pairhmm.local_posterior,
    "partition": partition.partition_posterior,
}


def _scan_params(mode: str, leave_prob: float | None, device,
                 dtype=torch.float32) -> dict:
    """Model -> log tables as `dtype` tensors on `device`, for the row
    scans ("qp" takes the Vtml200 partition model)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), dtype=dtype,
                               device=device)

    h5, lo, pt = mp.log_tables(mode, leave_prob)
    return {name: {k: t(v) for k, v in tab.items()}
            for name, tab in (("hmm5", h5), ("local", lo),
                              ("partition", pt))}


def _scan_fn(models: tuple[str, ...], with_matches: bool):
    """Row-scan posterior stage of one batch: each model's posterior (in
    the tables' dtype, then f32), the RMS, the MWT fill and the cutoff
    per-row top-k: (vals (B, Lp, k), idx, score[, nb])."""

    def run(X, Y, LX, LY, params):
        posts = [_SCAN_MODELS[m](X, Y, LX, LY, params[m]).float()
                 for m in models]
        if len(posts) == 1:
            post = posts[0]
        else:
            post = torch.sqrt(sum(p * p for p in posts) / len(posts))
        dirs, score = mwt.mwt_align(post, LX, LY)
        vals, idx = _row_topk(torch.where(post >= CUTOFF, post, 0.0), TOPK)
        if with_matches:
            return vals, idx, score, mwt.count_matches(dirs, LX, LY)
        return vals, idx, score

    return run


def _qp_exact_fn(with_matches: bool, tables,
                 mesh: PairsMesh | None = None):
    """qp twin of _wf_fn: same (vals, lanes, score[, nb]) contract."""

    def run(X, Y, LX, LY, tabs_f, tabs_r):
        post = _qpx_combined_skew(X, Y, LX, LY, tabs_f, tabs_r)
        return wk.mwt_topk(post, LX, LY, with_matches=with_matches,
                           topk=TOPK, cutoff=CUTOFF)

    return _shard_pairs(run, tables, mesh, (1, 1, 0, 0) if with_matches
                        else (1, 1, 0))


def _qp_exact_dense_fn(tables, mesh: PairsMesh | None = None):
    """qp twin of _wf_dense_fn: (dense grid plane, score)."""

    def run(X, Y, LX, LY, tabs_f, tabs_r):
        post = _qpx_combined_skew(X, Y, LX, LY, tabs_f, tabs_r)
        score, = wk.mwt_topk(post, LX, LY)
        dense = wavefront.unskew_posterior(post)
        return torch.where(dense >= CUTOFF, dense, 0.0), score

    return _shard_pairs(run, tables, mesh, (0, 0))


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
    (N, N, Lp, Lp) tensor; the consistency relaxation (MSA.cpp:1172-1360
    / ConsistencyStage.cpp:133-259) runs on it packed by true lengths,
    the pairs i < j only (consistency.relax_packed_rounds), and only the
    final sparse top-k extraction crosses to the host.  The full
    cutoff-thresholded posterior (not a top-k subset) goes through the
    relaxation (SparseMatrix.h:14).
    """

    def __init__(self, S, pairs, dist, seq_lens):
        self.S = S                  # (N, N, Lp, Lp) tensor, zero diagonal
        self.pairs = pairs
        self.dist = dist            # (N, N) np
        self.seq_lens = seq_lens

    def _pair_index(self, dev):
        return (torch.tensor([i for i, _ in self.pairs], device=dev),
                torch.tensor([j for _, j in self.pairs], device=dev))

    def _extract(self, planes) -> dict:
        """Top-k extract the (pairs, Lp, Lp) planes to host CSRs (the
        only device -> host crossing of the consistency path)."""
        with STATS.sub("topk_copy"):
            vals, idx = _row_topk(planes, EXTRACT_TOPK)
            vals = vals.cpu().numpy()
            idx = idx.cpu().numpy()
        posts = {}
        with STATS.sub("csr"):
            for k, (i, j) in enumerate(self.pairs):
                li, lj = self.seq_lens[i], self.seq_lens[j]
                posts[(i, j)] = topk_to_csr(vals[k], idx[k], li, lj)
            STATS.count("csr_entries",
                        sum(p.nnz for p in posts.values()))
        return posts

    def extract_csrs(self) -> dict:
        """Host CSRs of the unrelaxed posteriors."""
        ii, jj = self._pair_index(self.S.device)
        return self._extract(self.S[ii, jj])

    def relax_and_extract(
        self,
        weights: np.ndarray | None = None,
        selfweight: float = 3.0,
        selectivity: float = 200.0,
        reps: int = 2,
        final_cutoff: float | None = None,
    ) -> dict:
        """`reps` relaxation rounds on the device, host CSRs: baseMSA's
        without `weights`, QuickProbs' weighted accept-all with them.
        With a mesh, the rows of the dense pair matrix split over it;
        without, the tensor is packed by true lengths and the upper
        blocks relaxed (the counter `gemm_flops`)."""
        from mlprobs_tpu_torch.align import consistency as cons

        n, _, lp, _ = self.S.shape
        dev = self.S.device
        with STATS.sub("relax"):
            sc, zs, w = cons.dense_relax_coeffs(
                n, weights, selfweight=selfweight, selectivity=selectivity)
            mesh = _mesh(dev)
            if mesh is not None:
                ii, jj = self._pair_index(dev)
                S = _relax_sharded(self.S, sc, zs, w, reps, mesh,
                                   final_cutoff=final_cutoff)
                planes = S[ii, jj]
                del S
            else:
                packing = cons.Packing(self.seq_lens, self.pairs, lp, dev)
                R = cons.relax_packed_rounds(packing.pack(self.S), packing,
                                             sc, zs, w, reps=reps,
                                             final_cutoff=final_cutoff)
                planes = packing.unpack(R)
                del R
            STATS.count("pairs", len(self.pairs))
            STATS.count("rounds", reps)
        return self._extract(planes)


def _relax_sharded(S, sc, zs, w, reps: int, mesh: PairsMesh,
                   final_cutoff: float | None = None):
    """Dense relaxation rounds with the rows of the pair matrix split
    over the mesh (parallel/sharded.py), on the tensor's device at the
    end.  N is padded to a mesh multiple with zero rows, which
    contribute nothing.  Each round masks and thresholds as the
    single-device round, the last at `final_cutoff` when given."""
    from mlprobs_tpu_torch.parallel import sharded

    n = S.shape[0]
    npad = -(-n // mesh.size) * mesh.size
    if npad != n:
        p = npad - n
        S = torch.nn.functional.pad(S, (0, 0, 0, 0, 0, p, 0, p))
        sc = np.pad(sc, ((0, p), (0, p)))
        zs = np.pad(zs, ((0, p), (0, p)))
        w = np.pad(w, (0, p))
    relax = sharded.make_sharded_consistency(mesh, npad)
    sc, zs, w = (torch.from_numpy(a) for a in (sc, zs, w))
    home = S.device
    blocks = sharded.split_rows(S, mesh)
    del S
    for it in range(reps):
        c = (final_cutoff if final_cutoff is not None and it == reps - 1
             else CUTOFF)
        blocks = relax(blocks, sc, zs, w, cutoff=c)
    return sharded.gather_rows(blocks, home)[:n, :n]


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


def _count_pairs(seqs, pairs) -> None:
    """Count the pairs and their true cells (li * lj) of a posterior
    call."""
    STATS.count("pairs", len(pairs))
    STATS.count("cells", sum(len(seqs[i]) * len(seqs[j])
                             for i, j in pairs))


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
    if _engine() == "scan":
        report["consistency_downgrade"] = "engine:scan"
        return None
    lp = _bucket_len(max(len(s) for s in seqs))

    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    _count_pairs(seqs, pairs)
    tables = functools.partial(_wf_tables, mode, leave_prob)
    mesh = _mesh(device)
    fn = (_qp_exact_dense_fn(tables, mesh) if mode == "qp" and _qp_exact()
          else _wf_dense_fn(_MODE_MODELS[mode], tables, mesh))
    S = torch.zeros((n, n, lp, lp), dtype=torch.float32, device=device)
    dist = np.zeros((n, n))
    for chunk, X, Y, LX, LY in iter_pair_batches(
        seqs, pairs, device, force_lp=lp, mesh=mesh
    ):
        dense, score = fn(X, Y, LX, LY)
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
    per pair, from the engine that `_engine()` names.  A pair too long
    for a batch of several runs at B = 1 on the same device.  The
    "pallas" engine's batches split over the mesh, when there is one;
    the "scan" engine's do not (the JAX package's neither)."""
    device = devlib.resolve(device)
    mesh = None
    n = len(seqs)
    if pairs is None:
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    if _engine() == "scan":
        params = _scan_params(mode, leave_prob, device, torch.float64)
        scan = _scan_fn(_MODE_MODELS[mode], with_matches)

        def run(X, Y, LX, LY):
            return scan(X, Y, LX, LY, params)

        def to_csr(vals, idx, k, li, lj):
            return topk_to_csr(vals[k], idx[k], li, lj)
    else:
        tables = functools.partial(_wf_tables, mode, leave_prob)
        mesh = _mesh(device)
        run = (_qp_exact_fn(with_matches, tables, mesh)
               if mode == "qp" and _qp_exact()
               else _wf_fn(_MODE_MODELS[mode], with_matches, tables, mesh))

        def to_csr(vals, lanes, k, li, lj):
            return topk_diag_to_csr(vals[:, k], lanes[:, k], li, lj)
    for chunk, X, Y, LX, LY in iter_pair_batches(seqs, pairs, device,
                                                 mesh=mesh):
        _count_pairs(seqs, chunk)
        out = [o.cpu().numpy() for o in run(X, Y, LX, LY)]
        vals, idx, score = out[:3]
        for k, (i, j) in enumerate(chunk):
            li, lj = len(seqs[i]), len(seqs[j])
            csr = to_csr(vals, idx, k, li, lj)
            if with_matches:
                yield (i, j), csr, float(score[k]), int(out[3][k])
            else:
                yield (i, j), csr, float(score[k])


def viterbi_tables(blosum: np.ndarray, device) -> tuple:
    """(local log tables {lmatch, lins, trans}, vinit, blosum) of the
    feature pass, f32 tensors on `device`: the Viterbi kernel's inputs
    (ops/kernels/viterbi_kernel.py) besides the pair batch."""
    _, lo, _ = mp.log_tables("mix", None)
    pl = {k: torch.as_tensor(np.asarray(lo[k], np.float32), device=device)
          for k in ("lmatch", "lins", "trans")}
    return (pl, torch.as_tensor(VIT_INIT, device=device),
            torch.as_tensor(np.asarray(blosum, np.float32), device=device))


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
    device: one launch of the Viterbi kernel a batch
    (ops/kernels/viterbi_kernel.py) walks the paths where it wrote them.
    With a mesh, each device runs its share of a batch.
    """
    device = devlib.resolve(device)
    mesh = _mesh(device)
    tables = functools.cache(functools.partial(viterbi_tables, blosum))

    def body(x, y, lx, ly, pl, vinit, bl):
        return vk.viterbi_stats(x, y, lx, ly, pl, vinit, bl)[3:]

    stats_fn = _shard_pairs(body, tables, mesh, (0, 0, 1))
    for chunk, X, Y, LX, LY in iter_pair_batches(seqs, pairs, device,
                                                 mesh=mesh):
        plen, matches, scores_rev = stats_fn(X, Y, LX, LY)
        yield (chunk, plen.cpu().numpy(), matches.cpu().numpy(),
               scores_rev.cpu().numpy())


def viterbi_batches(
    seqs: Sequence[np.ndarray],
    pairs: Sequence[tuple[int, int]],
    device="cuda",
) -> Iterator[tuple[list[tuple[int, int]], np.ndarray, np.ndarray]]:
    """Yield (pair_chunk, dirs (nb, Lp+1, Lp+1) int8, end_states (nb,))
    of the row-scan Viterbi (ops/viterbi.viterbi_local) on the host, for
    the host traceback: the `scan` engine's feature pass, as the JAX
    package's `viterbi_batches`."""
    device = devlib.resolve(device)
    lo = _scan_params("mix", None, device)["local"]
    for chunk, X, Y, LX, LY in iter_pair_batches(seqs, pairs, device):
        dirs, ends, _ = viterbi.viterbi_local(X, Y, LX, LY, lo)
        yield chunk, dirs.cpu().numpy(), ends.cpu().numpy()


def all_pairs_viterbi(
    seqs: Sequence[np.ndarray],
    pairs: Sequence[tuple[int, int]] | None = None,
    device="cuda",
) -> Iterator[tuple[tuple[int, int], np.ndarray, int]]:
    """Yield ((i, j), packed direction matrix (li+1, lj+1), end_state)
    per pair, from `viterbi_batches`."""
    n = len(seqs)
    if pairs is None:
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    for chunk, dirs, ends in viterbi_batches(seqs, pairs, device):
        for k, (i, j) in enumerate(chunk):
            li, lj = len(seqs[i]), len(seqs[j])
            yield (i, j), dirs[k, : li + 1, : lj + 1], int(ends[k])
