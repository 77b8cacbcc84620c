"""Family aligner: the pnp base aligner and the realigner on PyTorch.

`align_family(..., config="pnp")` reproduces baseMSA/C_P_NP_Aln: with
`strategy=0` its progressive path (pdoAlign, MSA.cpp:895-1081):
model-adaptation test, identity-dependent posterior model mixing, UPGMA
guide tree, two rounds of consistency, weighted profile-profile
progressive merge and adaptive iterative refinement; with `strategy=1`
its non-progressive path (npdoAlign): the same posteriors with match
counts, two rounds of consistency, the alignment graph (align/graph.py)
and the similar-set refinement (align/refine_np.py).  The posteriors run
on the card's kernels; with device="cpu", on their plain PyTorch
versions.  A family over the dense consistency tensor's budget is
relaxed by sectors on the device (align/sector.py).

`config="quickprobs"` is the realignment aligner used for column blocks
(the role QuickProbs plays in the reference): the QuickProbs-style
posterior (the qpx hmm5 posterior RMS-combined with the sweep's partition
posterior, PosteriorStage.cpp:123-196), weighted consistency, weighted
construction and a fixed small refinement budget.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mlprobs_tpu_torch.align import consistency as cons
from mlprobs_tpu_torch.align import pairwise, progressive, refine_qp
from mlprobs_tpu_torch.align import sector as sectorlib
from mlprobs_tpu_torch.align import tree as treelib
from mlprobs_tpu_torch.align import tree_extra
from mlprobs_tpu_torch.align.graph import graph_align
from mlprobs_tpu_torch.align.refine_np import np_refinement
from mlprobs_tpu_torch.align.traceback import viterbi_traceback
from mlprobs_tpu_torch.core.config import DEFAULT as _CFG
from mlprobs_tpu_torch.core.msa import MSA
from mlprobs_tpu_torch.models import params as mp
from mlprobs_tpu_torch.utils import device as devlib
from mlprobs_tpu_torch.utils.crand import GlibcRand
from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS


@dataclass
class FamilyStats:
    """All-pairs Viterbi statistics (ModelAdjustmentTest)."""

    avg_pid: float
    sd_pid: float
    pid_class: int
    variance_bit: int
    num_seqs: int
    # feature-pass extras (Alter_ModelAdjustmentTest)
    avg_len: int = 0
    avg_sp: float = 0.0
    peak_ratio: float = 0.0
    factor: float = 0.0


def family_viterbi_stats(
    seqs: list[np.ndarray], with_features: bool = False, device="cuda",
) -> FamilyStats:
    """All-pairs local Viterbi PID statistics, computed on the device (the
    wavefront Viterbi; under the `scan` engine the row-scan Viterbi with a
    host traceback, as the JAX package).

    With `with_features`, also aggregates the `-G` feature-pass numbers
    (MSA.cpp:646-762): mean per-column BLOSUM profile over pairwise
    alignments, average SP over all alignment columns, peak-length ratio
    (theta = 1.0) and factor = 2N - avg_alignment_len.
    """
    device = devlib.resolve(device)
    n = len(seqs)
    npairs = n * (n - 1) // 2
    bl = np.asarray(mp.blosum62(), dtype=np.float64)
    pair_list = [(i, j) for i in range(n) for j in range(i + 1, n)]
    pids_all: list[np.ndarray] = []
    total_len = 0
    max_len = 0
    cap = 2 * max(len(s) for s in seqs) + 2
    col_acc = np.zeros(cap, dtype=np.float64)
    sp_sum, sp_cols = 0.0, 0.0
    if pairwise._engine() == "scan":
        # the row-scan Viterbi's directions, traced back on the host
        for chunk, dirs, ends in pairwise.viterbi_batches(seqs, pair_list,
                                                          device):
            for k, (i, j) in enumerate(chunk):
                path = viterbi_traceback(dirs[k], int(ends[k]),
                                         len(seqs[i]), len(seqs[j]))
                plen = len(path)
                total_len += plen
                max_len = max(max_len, plen)
                a = seqs[i][np.cumsum(path != 2) - 1]
                b = seqs[j][np.cumsum(path != 1) - 1]
                is_b = path == 0
                matches = int(((a == b) & is_b).sum())
                pids_all.append(np.array([matches / plen]))
                scores = np.where(is_b & (a < 20) & (b < 20), bl[a, b], 0.0)
                scores = np.where(scores < 10, scores, 0.0)
                col_acc[:plen] += scores
                sp_sum += float(scores.sum())
                sp_cols += plen
        return _finish_family_stats(
            pids_all, n, npairs, total_len, max_len, col_acc,
            sp_sum, sp_cols, with_features,
        )
    # only per-pair scalars and the per-step score table cross to the host
    for chunk, plen, matches, scores_rev in (
        pairwise.viterbi_stat_batches(seqs, pair_list, bl, device)
    ):
        for k in range(len(chunk)):
            n_path = int(plen[k])
            total_len += n_path
            max_len = max(max_len, n_path)
            pids_all.append(
                np.array([matches[k] / n_path if n_path else 0.0])
            )
            srev = scores_rev[:n_path, k]
            col_acc[:n_path] += srev[::-1]
            sp_sum += float(srev.sum())
            sp_cols += n_path
    return _finish_family_stats(
        pids_all, n, npairs, total_len, max_len, col_acc,
        sp_sum, sp_cols, with_features,
    )


def _finish_family_stats(
    pids_all, n, npairs, total_len, max_len, col_acc, sp_sum, sp_cols,
    with_features,
) -> FamilyStats:
    pids = np.concatenate(pids_all)
    avg = float(pids.mean())
    sd = float(np.sqrt(((pids - avg) ** 2).mean()))
    st = FamilyStats(
        avg_pid=avg,
        sd_pid=sd,
        pid_class=mp.pid_class(avg),
        variance_bit=mp.variance_bit(sd),
        num_seqs=n,
    )
    if with_features:
        st.avg_len = total_len // npairs
        st.avg_sp = sp_sum / sp_cols if sp_cols else 0.0
        profile = col_acc[:max_len] / npairs
        st.peak_ratio = (
            float((profile >= 1.0).sum()) / max_len if max_len else 0.0
        )
        st.factor = 2.0 * n - st.avg_len
    return st


_MODE_BY_PID = {0: "mix", 1: "mix", 2: "local", 3: "partition",
                4: "partition"}


def posterior_stage(
    seqs: list[np.ndarray], mode: str, leave_prob: float | None,
    device="cuda", similarity: bool = False,
) -> tuple[dict, np.ndarray]:
    """All-pairs sparse posteriors and the expected-accuracy distance
    matrix; with `similarity`, the NP path's matrix score / #matches
    instead (MSA.cpp:1745-1752), from the kernels' match counts."""
    n = len(seqs)
    posts: dict = {}
    dist = np.zeros((n, n))
    for (i, j), post_csr, score, *nb in pairwise.all_pairs_posteriors(
        seqs, mode=mode, leave_prob=leave_prob, with_matches=similarity,
        device=device,
    ):
        posts[(i, j)] = post_csr
        if similarity:
            d = score / nb[0] if nb[0] else 0.0
        else:
            d = 1.0 - score / min(len(seqs[i]), len(seqs[j]))
        dist[i, j] = dist[j, i] = d
    return posts, dist


def _sector_or_host(posts, lengths, report, device, host_relax, **kw):
    """Relax a family over the dense tensor's budget by sectors on the
    device; the plan over its own budget or a device OOM demotes to
    `host_relax`, recorded in the report."""
    try:
        out = sectorlib.relax_sector_device(posts, lengths, device=device,
                                            report=report, **kw)
        report["consistency_engine"] = "sector"
        return out
    except (torch.cuda.OutOfMemoryError, sectorlib.SectorOverBudget) as e:
        report["consistency_downgrade"] = f"oom_sector: {e}"[:160]
        report["consistency_engine"] = "host"
        return host_relax(posts)


def _partition_dp_seqs(seqs: list[np.ndarray]) -> list[np.ndarray]:
    """Unknown residues for the baseMSA partition model map to matrix
    index 0 ('A'): read_matrix only initialises subst_index[0..19] to
    -1, so letters past 'T'-'A' (X, Z, U) fall through to the
    zero-initialised entry (MSAReadMatrix.cpp:91-96,
    MSAPartProbs.cpp:236-238)."""
    return [np.where(s == 20, 0, s).astype(s.dtype) for s in seqs]


def align_family(
    records: list[tuple[str, str]],
    config: str = "pnp",
    stats: FamilyStats | None = None,
    strategy: int = 0,
    report: dict | None = None,
    observer=None,
    keep: dict | None = None,
    device="cuda",
) -> MSA:
    """Align one family of unaligned sequences; returns the final MSA.

    `config="pnp"` is the base aligner, progressive (`strategy=0`) or
    non-progressive (`strategy=1`); `config="quickprobs"` the
    QuickProbs-role realigner.  `report`, when given, records which
    engines ran and every downgrade: the consistency engine ("device",
    "sector" or "host") and, when the device tensor was not used for the
    relaxation, `report["consistency_downgrade"]`.  `observer` is the
    realigner's refinement iteration hook (IRefinementObserver /
    ExtendedMSA::iterationDone autosave role).
    """
    if config not in ("pnp", "quickprobs"):
        raise ValueError(config)
    if strategy not in (0, 1):
        raise ValueError(strategy)
    device = devlib.resolve(device)
    if report is None:
        report = {}
    report["device"] = str(device)
    report["posterior_engine"] = (
        "row-scan" if pairwise._engine() == "scan"
        else "cuda-kernels" if device.type == "cuda" else "plain-torch"
    )
    msa = MSA.from_unaligned(records)
    seqs = [np.asarray(s[s >= 0]) for s in msa.rows]
    n = len(seqs)
    if n == 1:
        return msa
    if config == "quickprobs":
        return _align_quickprobs(msa, seqs, report, observer, keep, device)
    rng = GlibcRand(1)

    if stats is None:
        with STATS.timer("features"):
            stats = family_viterbi_stats(seqs, device=device)
    pid = stats.pid_class
    vbit = stats.variance_bit
    leave = mp.adaptive_leave_prob(stats.avg_pid)
    mode = _MODE_BY_PID[pid]
    report["mode"] = mode

    lengths = [len(s) for s in seqs]
    dp_seqs = _partition_dp_seqs(seqs) if mode == "partition" else seqs
    if strategy == 1:
        return _align_np(msa, seqs, dp_seqs, mode, leave, report, keep,
                         device)
    tensor = None
    try:
        with STATS.timer("posteriors"):
            tensor = pairwise.device_posterior_tensor(
                dp_seqs, mode, leave, report=report, device=device
            )
    except torch.cuda.OutOfMemoryError as e:
        report["consistency_downgrade"] = f"oom_tensor: {e}"[:160]
        tensor = None
    report["consistency_engine"] = (
        "device" if tensor is not None else "host"
    )
    if tensor is not None:
        dist = tensor.dist
        try:
            with STATS.timer("consistency"):
                posts = tensor.relax_and_extract(reps=2)
        except torch.cuda.OutOfMemoryError as e:
            report["consistency_downgrade"] = f"oom_relax: {e}"[:160]
            report["consistency_engine"] = "host"
            with STATS.timer("consistency"):
                posts = cons.relax_sparse(
                    tensor.extract_csrs(), lengths, reps=2
                )
        del tensor
    else:
        with STATS.timer("posteriors"):
            posts, dist = posterior_stage(dp_seqs, mode, leave, device)

        def host_relax(p):
            return cons.relax_sparse(p, lengths, reps=2)

        with STATS.timer("consistency"):
            if pairwise.tensor_bytes_over_budget(dp_seqs, device):
                posts = _sector_or_host(posts, lengths, report, device,
                                        host_relax, reps=2)
            else:
                posts = host_relax(posts)
    if keep is not None:
        keep["posts"] = posts
    with STATS.timer("merge"):
        root = treelib.upgma(dist, variance_id=vbit)
        out = progressive.compute_final_alignment(
            root, msa, posts, pid=pid, rng=rng, base_reps=100
        )
    STATS.log_device_memory("pnp")
    return out


def _align_np(msa, seqs, dp_seqs, mode, leave, report, keep, device) -> MSA:
    """The non-progressive path (npdoAlign): posteriors with match
    counts on the device, similarities score / #matches (MSA.cpp:
    1745-1752), two rounds of host consistency, the alignment graph and
    the similar-set refinement, as the JAX package's aligner.py:303-327."""
    lengths = [len(s) for s in seqs]
    report["consistency_engine"] = "host"
    with STATS.timer("posteriors"):
        posts, sim = posterior_stage(dp_seqs, mode, leave, device,
                                     similarity=True)
    with STATS.timer("consistency"):
        posts = cons.relax_sparse(posts, lengths, reps=2)
    if keep is not None:
        keep["posts"] = posts
    with STATS.timer("graph"):
        out = graph_align(msa, posts, seqs, report=report)
    with STATS.timer("np_refinement"):
        out = np_refinement(out, posts, sim, GlibcRand(12345),
                            base_reps=100)
    STATS.log_device_memory("np")
    return out


# guide-tree builders of the realigner (ExtendedMSA.cpp:86-99)
_QP_TREES = {
    "slink": lambda dist, n: tree_extra.slink(dist),
    "chained": lambda dist, n: tree_extra.chained(n),
    "upgma": lambda dist, n: treelib.upgma(dist, variance_id=1),
}
# the largest combined distance per unit of the selectivity function
_FUNC_BOUND = {"max": 1.0, "min": 1.0, "sum": 2.0, "avg": 1.5}


def _align_quickprobs(msa, seqs, report, observer, keep, device) -> MSA:
    """QuickProbs pipeline (ExtendedMSA.cpp:66-184 with the defaults of
    Configuration.cpp:84-135): guide tree by kind, selectivity distance
    preparation + normalization, saturated weights, weighted relaxation
    with selfweight 3, weighted construction, refinement by type.

    The relaxation runs on the device tensor when the deterministic
    filter accepts every z, or by sectors on the device when such a
    family is over the tensor's budget; the stochastic filter, a sector
    plan over its own budget and a device OOM take the host weighted
    relaxation, and the report says which."""
    rcfg = _CFG.realigner
    n = len(seqs)
    lengths = [len(s) for s in seqs]
    rng = GlibcRand(1)
    report["mode"] = "qp"
    tensor = None
    try:
        with STATS.timer("qp_posteriors"):
            tensor = pairwise.device_posterior_tensor(
                seqs, "qp", None, report=report, device=device
            )
    except torch.cuda.OutOfMemoryError as e:
        report["consistency_downgrade"] = f"oom_tensor: {e}"[:160]
    report["consistency_engine"] = "device" if tensor is not None else "host"
    if tensor is not None:
        posts, dist = None, tensor.dist
    else:
        with STATS.timer("qp_posteriors"):
            posts, dist = posterior_stage(seqs, "qp", None, device)
    root = _QP_TREES[rcfg.tree_kind](dist, n)
    weights_f = cons.saturate_weights(
        treelib.qp_weights(root, n), rcfg.saturation
    )
    c_reps = (rcfg.consistency_reps if n <= rcfg.large_family_threshold
              else rcfg.consistency_reps_large)
    cd = cons.selectivity_distances(
        rcfg.selectivity_mode, dist,
        subtree=tree_extra.subtree_distances(root, n),
        selectivity=rcfg.selectivity,
        normalization=rcfg.selectivity_normalization,
    )
    # accept-all shortcut: the deterministic filter passes every z when
    # no combined distance can exceed the selectivity bound
    accept_all = (
        rcfg.selectivity_filter == "deterministic"
        and cd.max() * _FUNC_BOUND[rcfg.selectivity_function]
        <= rcfg.selectivity
    )

    def host_weighted_relax(posts_csr):
        return cons.relax_sparse_weighted(
            posts_csr, lengths, weights_f, reps=c_reps,
            selfweight=rcfg.selfweight, selectivity=rcfg.selectivity,
            distances=None if accept_all else cd,
            final_cutoff=rcfg.consistency_final_cutoff,
        )

    with STATS.timer("qp_consistency"):
        if tensor is not None and accept_all:
            try:
                posts = tensor.relax_and_extract(
                    weights=weights_f, reps=c_reps,
                    selfweight=rcfg.selfweight,
                    selectivity=rcfg.selectivity,
                    final_cutoff=rcfg.consistency_final_cutoff,
                )
            except torch.cuda.OutOfMemoryError as e:
                report["consistency_downgrade"] = f"oom_relax: {e}"[:160]
                report["consistency_engine"] = "host"
                posts = host_weighted_relax(tensor.extract_csrs())
        elif accept_all and pairwise.tensor_bytes_over_budget(seqs, device):
            posts = _sector_or_host(
                posts, lengths, report, device, host_weighted_relax,
                reps=c_reps, weights=weights_f, selfweight=rcfg.selfweight,
                selectivity=rcfg.selectivity,
                final_cutoff=rcfg.consistency_final_cutoff)
        else:
            if posts is None:
                # stochastic-filter regime: host relaxation of the
                # already-built device tensor's posteriors
                report["consistency_downgrade"] = "stochastic_filter"
                report["consistency_engine"] = "host"
                posts = tensor.extract_csrs()
            posts = host_weighted_relax(posts)
    del tensor
    if keep is not None:
        keep["posts"] = posts
    weights_c = cons.saturate_weights(
        treelib.qp_weights(root, n), rcfg.final_saturation
    )
    # QuickProbs construction does NOT subtract the posterior cutoff:
    # ConstructionStage::alignAlignments calls the parallel
    # buildPosterior (ParallelProbabilisticModel.cpp:301-445), which
    # plain-scatters w*v
    with STATS.timer("qp_construction"):
        out = progressive.process_tree(root, msa, posts, weights_c,
                                       cutoff_sub=0.0)
    iters = (rcfg.refinement_reps if n <= rcfg.refinement_threshold
             else rcfg.refinement_reps_large)
    accept = {"acceptance_length": rcfg.acceptance_length,
              "acceptance_entropy": rcfg.acceptance_entropy,
              "observer": observer}
    with STATS.timer("qp_refinement"):
        if rcfg.refinement_type == "random":
            out = refine_qp.random_refinement(
                out, posts, weights_c, rng, iters, **accept)
        elif rcfg.refinement_type == "tree":
            out = refine_qp.tree_refinement(
                out, posts, weights_c, rng, iters, root, **accept)
        else:
            out = refine_qp.column_refinement(
                out, posts, weights_c, iterations=iters,
                max_depth=rcfg.max_depth,
                column_fraction=rcfg.column_fraction,
                ignore_terminal_gaps=rcfg.ignore_terminal_gaps,
                num_seqs_total=n, **accept)
    STATS.log_device_memory("quickprobs")
    return out
