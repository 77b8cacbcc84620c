# Frozen copy of mlprobs_tpu_torch/models/params.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Pair-HMM / partition-function parameter sets, in log space.

Numerically equivalent to the reference models:

* 5-state double-affine pair-HMM (ProbCons lineage) — reference
  ProbabilisticModel.h:58-135 builds the transition matrix from
  (initDistrib, gapOpen, gapExtend); emissions from Defaults.h tables.
* 3-state local pair-HMM with flanking random states (GLProbs lineage) —
  same constructor, `local_transProb` / `random_transProb`.
* Partition-function (Probalign) global model — MSAReadMatrix.cpp:158-209:
  Gonnet-160 scores exponentiated by beta=1/T (T=5), gap open -22,
  gap extend -1, free terminal gaps.

All tables are float32 numpy arrays holding *log* probabilities, with 21
residue classes (20 aa + unknown).  The family-adaptive parameter
`init2[2]` (probability of leaving a flanking random state) is a function
of average family identity — reference MSA.cpp:861-870.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path

import numpy as np

NEG_INF = np.float32(-2e20)  # matches reference LOG_ZERO (ScoreType.h:17)

_ASSETS = Path(__file__).resolve().parent / "assets"


@functools.lru_cache(maxsize=1)
def raw_params() -> dict[str, np.ndarray]:
    with np.load(_ASSETS / "params.npz") as z:
        return {k: z[k] for k in z.files}


def _log(x):
    x = np.asarray(x, dtype=np.float64)
    with np.errstate(divide="ignore"):
        out = np.log(x)
    return np.where(np.isfinite(out), out, NEG_INF).astype(np.float32)


@dataclass(frozen=True)
class Hmm5Params:
    """Log-space parameters of the 5-state double-affine pair-HMM.

    State order: 0=M, 1=X1, 2=Y1, 3=X2, 4=Y2 (Xk consume sequence x,
    Yk consume sequence y; k=1 short gaps, k=2 long gaps).
    """

    init: np.ndarray          # (5,)   log initial distribution
    trans: np.ndarray         # (5,5)  log transition matrix
    lmatch: np.ndarray        # (21,21) log match emission
    lins: np.ndarray          # (21,2) log insert emission per gap class


@dataclass(frozen=True)
class HmmLocalParams:
    """Log-space parameters of the 3-state local pair-HMM.

    State order: 0=M, 1=X, 2=Y.  `log_stay` is the log-probability of
    staying in a flanking random state (the odds-ratio correction term);
    `log_leave` of leaving it.  Both derive from the family-adaptive
    initDistrib[2].
    """

    trans: np.ndarray         # (3,3) log central transition matrix
    lmatch: np.ndarray        # (21,21)
    lins: np.ndarray          # (21,)  log single-residue emission
    log_stay: np.float32
    log_leave: np.float32


@dataclass(frozen=True)
class PartitionParams:
    """Probalign partition-function model, log space."""

    lscore: np.ndarray        # (21,21) beta * gonnet160  (= log exp-matrix)
    lgap_open: np.float32     # beta * (-22)
    lgap_ext: np.float32      # beta * (-1)
    lterm_gap: np.float32     # 0.0 — free terminal gaps


def _affine_trans(gap_open: np.ndarray, gap_ext: np.ndarray) -> np.ndarray:
    """Build the (1+2k)-state transition matrix the reference way.

    cf. ProbabilisticModel.h:75-90: M->{Xk,Yk} = gapOpen[2k],
    {Xk,Yk} self = gapExtend[2k], {Xk,Yk}->M = 1-gapExtend[2k],
    M->M = 1 - 2*sum(gapOpen[2k]).
    """
    k = len(gap_open) // 2
    n = 1 + 2 * k
    t = np.zeros((n, n), dtype=np.float64)
    mm = 1.0
    for i in range(k):
        go, ge = gap_open[2 * i], gap_ext[2 * i]
        x, y = 2 * i + 1, 2 * i + 2
        t[0, x] = t[0, y] = go
        mm -= 2 * go
        t[x, x] = t[y, y] = ge
        t[x, 0] = t[y, 0] = 1.0 - ge
    t[0, 0] = mm
    return t


def _emission_tables() -> tuple[np.ndarray, np.ndarray]:
    p = raw_params()
    lmatch = np.full((21, 21), np.log(1e-10))
    lmatch[:20, :20] = np.log(p["emit_pairs"])
    lsingle = np.full(21, np.log(1e-5))
    lsingle[:20] = np.log(p["emit_single"])
    return lmatch.astype(np.float32), lsingle.astype(np.float32)


@functools.lru_cache(maxsize=1)
def hmm5_params() -> Hmm5Params:
    p = raw_params()
    init = p["init2"].copy()
    # reference corrects initialDistribution[2] to initDistribMat[1]
    # (ProbabilisticModel.h:101-102)
    init[2] = init[1]
    trans = _affine_trans(p["gap_open2"], p["gap_ext2"])
    lmatch, lsingle = _emission_tables()
    lins = np.stack([lsingle, lsingle], axis=1)  # same table for both classes
    return Hmm5Params(
        init=_log(init), trans=_log(trans), lmatch=lmatch, lins=lins
    )


def hmm_local_params(leave_prob: float | None = None) -> HmmLocalParams:
    """Local-model parameters; `leave_prob` is the adaptive initDistrib[2]."""
    p = raw_params()
    if leave_prob is None:
        # the runtime default is initDistrib2Default[2] (MSA.cpp:462)
        leave_prob = float(p["init2"][2])
    go, ge = p["gap_open2"][1], p["gap_ext2"][1]  # gapOpen[1]/gapExtend[1]
    t = np.array(
        [
            [1.0 - 2 * go, go, go],
            [1.0 - ge, ge, 0.0],
            [1.0 - ge, 0.0, ge],
        ]
    )
    lmatch, lsingle = _emission_tables()
    return HmmLocalParams(
        trans=_log(t),
        lmatch=lmatch,
        lins=lsingle,
        log_stay=np.float32(np.log(1.0 - leave_prob)),
        log_leave=np.float32(np.log(leave_prob)),
    )


def adaptive_leave_prob(identity: float) -> float:
    """Family-adaptive flanking-state leave probability.

    Identity-bucketed values from reference MSA.cpp:861-870; families with
    identity > 0.5 keep the default initDistrib1[2].
    """
    table = [
        (0.125, 0.108854),
        (0.15, 0.132548),
        (0.175, 0.165248),
        (0.2, 0.168284),
        (0.25, 0.170705),
        (0.3, 0.100675),
        (0.35, 0.090755),
        (0.4, 0.146188),
        (0.45, 0.167858),
        (0.5, 0.250769),
    ]
    for hi, v in table:
        if identity <= hi:
            return v
    return float(raw_params()["init2"][2])


@functools.lru_cache(maxsize=1)
def partition_params() -> PartitionParams:
    p = raw_params()
    beta = 1.0 / 5.0
    return PartitionParams(
        lscore=(beta * p["gonnet160"]).astype(np.float32),
        lgap_open=np.float32(beta * -22.0),
        lgap_ext=np.float32(beta * -1.0),
        lterm_gap=np.float32(0.0),
    )


@functools.lru_cache(maxsize=1)
def partition_params_qp() -> PartitionParams:
    """QuickProbs partition model: Vtml200, gap -25.3549 / -1.30113,
    T = 5.6007 (Configuration.cpp:321-333)."""
    p = raw_params()
    beta = 1.0 / 5.6007
    return PartitionParams(
        lscore=(beta * p["vtml200"]).astype(np.float32),
        lgap_open=np.float32(beta * -25.3549),
        lgap_ext=np.float32(beta * -1.30113),
        lterm_gap=np.float32(0.0),
    )


@functools.lru_cache(maxsize=1)
def blosum62() -> np.ndarray:
    """BLOSUM62 over 21 classes; unknown row/col = 0 (column scorer skips)."""
    out = np.zeros((21, 21), dtype=np.float32)
    out[:20, :20] = raw_params()["blosum62"]
    return out


def pid_class(identity: float) -> int:
    """Posterior-model selector from average identity (MSA.cpp:873-881)."""
    if identity <= 0.18:
        return 0
    if identity <= 0.25:
        return 1
    if identity <= 0.4:
        return 2
    if identity <= 0.7:
        return 3
    return 4


def variance_bit(sd_pid: float) -> int:
    """Guide-tree linkage selector: 1 if sd(PID) > 0.115 (MSA.cpp:872-874)."""
    return 1 if sd_pid > 0.115 else 0


# ---------------------------------------------------------------------------
# Probability tables for the wavefront engine and its kernels
# ---------------------------------------------------------------------------

PAD = 20  # padding alphabet class: every probability table is zero for it


def log_tables(mode: str, leave_prob: float | None):
    """Plain-numpy log-space parameter dicts (h5, lo, pt) for a mode.

    The format of the JAX package's `pairwise.native_tables`: "qp" takes
    the QuickProbs partition model, every other mode the baseMSA one.
    """
    p5 = hmm5_params()
    pl = hmm_local_params(leave_prob)
    pp = partition_params_qp() if mode == "qp" else partition_params()
    h5 = {"init": p5.init, "trans": p5.trans,
          "lmatch": p5.lmatch, "lins": p5.lins}
    lo = {"trans": pl.trans, "lmatch": pl.lmatch, "lins": pl.lins,
          "log_stay": float(pl.log_stay)}
    pt = {"lscore": pp.lscore, "lgap_open": float(pp.lgap_open),
          "lgap_ext": float(pp.lgap_ext)}
    return h5, lo, pt


def _zero_pad_class(tab):
    """Zero row/col PAD of a (21, ...) probability table."""
    tab = tab.clone()
    tab[PAD] = 0.0
    if tab.ndim == 2 and tab.shape[1] == 21:
        tab[:, PAD] = 0.0
    return tab


def tables_from_numpy(h5: dict, lo: dict, pt: dict, device="cpu"):
    """Probability tables (tabs_f, tabs_r) from log-space numpy dicts.

    h5/lo/pt are in the format of `log_tables` (and of the JAX package's
    `pairwise.native_tables`).  Returns two dicts model -> dict of f32
    tensors on `device`, as the JAX package's `wavefront.PROB_TABLES`
    builds them: hmm5 {pm, pins, T, init}, local {pm, T, c1, c2},
    partition {pm, go, ge}.  `tabs_r` holds the transposed transition
    matrices of the reverse pass; the partition model needs none.
    """
    import torch

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    trans5 = torch.exp(t(h5["trans"]))
    lmatch = t(lo["lmatch"])
    lins = t(lo["lins"])
    lm = lmatch - lins[:, None] - lins[None, :]
    log_stay = t(lo["log_stay"])
    transl = torch.exp(t(lo["trans"]))
    h5_common = {
        "pm": _zero_pad_class(torch.exp(t(h5["lmatch"]))),
        "pins": _zero_pad_class(torch.exp(t(h5["lins"]))),
        "init": torch.exp(t(h5["init"])),
    }
    lo_common = {
        "pm": _zero_pad_class(torch.exp(lm)),
        "c1": torch.exp(-log_stay),
        "c2": torch.exp(-2.0 * log_stay),
    }
    part = {
        "pm": _zero_pad_class(torch.exp(t(pt["lscore"]))),
        "go": torch.exp(t(pt["lgap_open"])),
        "ge": torch.exp(t(pt["lgap_ext"])),
    }
    tabs_f = {
        "hmm5": dict(h5_common, T=trans5),
        "local": dict(lo_common, T=transl),
        "partition": part,
    }
    tabs_r = {
        "hmm5": dict(h5_common, T=trans5.T.contiguous()),
        "local": dict(lo_common, T=transl.T.contiguous()),
        "partition": part,
    }
    return tabs_f, tabs_r
