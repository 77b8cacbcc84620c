"""Family aligner: the progressive pnp base aligner on PyTorch.

`align_family(..., config="pnp")` reproduces the progressive path of
baseMSA/C_P_NP_Aln (pdoAlign, MSA.cpp:895-1081): model-adaptation test,
identity-dependent posterior model mixing, UPGMA guide tree, two rounds
of consistency, weighted profile-profile progressive merge and adaptive
iterative refinement.  The posteriors run on the card's kernels; with
device="cpu", on their plain PyTorch versions.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mlprobs_tpu_torch.align import consistency as cons
from mlprobs_tpu_torch.align import pairwise, progressive
from mlprobs_tpu_torch.align import tree as treelib
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
    """All-pairs local Viterbi PID statistics, computed on the device.

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
    device="cuda",
) -> tuple[dict, np.ndarray]:
    """All-pairs sparse posteriors + expected-accuracy distance matrix."""
    n = len(seqs)
    posts: dict = {}
    dist = np.zeros((n, n))
    for (i, j), post_csr, score in pairwise.all_pairs_posteriors(
        seqs, mode=mode, leave_prob=leave_prob, device=device
    ):
        posts[(i, j)] = post_csr
        d = 1.0 - score / min(len(seqs[i]), len(seqs[j]))
        dist[i, j] = dist[j, i] = d
    return posts, dist


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
    keep: dict | None = None,
    device="cuda",
) -> MSA:
    """Align one family of unaligned sequences; returns the final MSA.

    Only the progressive pnp path (`config="pnp"`, `strategy=0`) is
    ported.  `report`, when given, records which engines ran and every
    downgrade: the consistency engine ("device" or "host") and, when the
    device tensor was not used, `report["consistency_downgrade"]`.
    """
    if config == "quickprobs":
        raise NotImplementedError(
            "config='quickprobs' is not ported yet (ROADMAP queue 1: the "
            "quickprobs/qpx realigner)"
        )
    if config != "pnp":
        raise ValueError(config)
    if strategy == 1:
        raise NotImplementedError(
            "strategy=1 is not ported yet (ROADMAP queue 1: the NP path, "
            "graph.py and refine_np.py)"
        )
    if strategy != 0:
        raise ValueError(strategy)
    device = devlib.resolve(device)
    if report is None:
        report = {}
    report["device"] = str(device)
    report["posterior_engine"] = (
        "cuda-kernels" if device.type == "cuda" else "plain-torch"
    )
    msa = MSA.from_unaligned(records)
    seqs = [np.asarray(s[s >= 0]) for s in msa.rows]
    n = len(seqs)
    if n == 1:
        return msa
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
        with STATS.timer("consistency"):
            posts = cons.relax_sparse(posts, lengths, reps=2)
    if keep is not None:
        keep["posts"] = posts
    with STATS.timer("merge"):
        root = treelib.upgma(dist, variance_id=vbit)
        out = progressive.compute_final_alignment(
            root, msa, posts, pid=pid, rng=rng, base_reps=100
        )
    STATS.log_device_memory("pnp")
    return out
