"""QuickProbs refinement family (Column / Random / Tree + acceptance).

Reference: RefinementBase.cpp (template method: iterations 30 small /
200 large with threshold 200; split -> extract -> realign ->
checkAcceptance), ColumnRefinement.cpp (scored-column split with
columnFraction / recursion to min(maxDepth, log2 N)),
RandomRefinement.cpp (RNG bipartition), TreeRefinement.cpp (subtree
cut) and EntropyEvaluator.cpp (property-weighted column entropy).

RNG: every refinement run constructs a default std::mt19937 and draws
division columns through det_uniform_int_distribution — reproduced
exactly via utils.qprand.
"""
from __future__ import annotations

import math

import numpy as np

from mlprobs_tpu_torch.align.progressive import (
    PostPool, build_profile_posterior, mwt_path,
)
from mlprobs_tpu_torch.core.msa import MSA, merge_alignments
from mlprobs_tpu_torch.utils import qprand
from mlprobs_tpu_torch.utils.crand import GlibcRand
from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS

# QuickProbs refinement realigns groups through the same parallel
# buildPosterior as construction (RefinementBase::refine ->
# ConstructionStage::alignAlignments ->
# ParallelProbabilisticModel.cpp:301-445), which does NOT subtract the
# posterior cutoff — the subtracting base-class variants are dead code
# in this fork.
CUTOFF = 0.0

# AminoAcidProperties.cpp:19-40 (bit flags, 10 properties)
_PROPS = {
    "A": 2 | 1 | 16, "C": 2 | 1 | 16 | 32, "D": 128 | 256 | 32 | 1,
    "E": 128 | 256 | 32, "F": 8 | 16, "G": 2 | 1 | 16,
    "H": 8 | 64 | 256 | 32 | 16, "I": 4 | 16, "K": 64 | 256 | 32 | 16,
    "L": 4 | 16, "M": 16, "N": 1 | 32, "P": 512 | 1, "Q": 32,
    "R": 64 | 256 | 32, "S": 2 | 1 | 32, "T": 32 | 16 | 1,
    "V": 1 | 4 | 16, "W": 8 | 32 | 16, "Y": 8 | 32 | 16,
}
_ALPHA = "ARNDCQEGHILKMFPSTWYV"


def entropy_evaluator(alignment: MSA) -> float:
    """Reference-exact alignment score (EntropyEvaluator.cpp:15-73).

    Per column: (1 - entropy) * propScore * (1 - gapFraction), where
    the histogram is initialised at 0.5 per symbol, symbolsCount starts
    at 10, and propScore counts shared/united property bits."""
    rows = alignment.rows
    n, length = rows.shape
    if n == 0 or length == 0:
        return 0.0
    lam = 1.0 / math.log2(20)
    total = 0.0
    for c in range(length):
        col = rows[:, c]
        res = col[col >= 0]
        gap_count = int((col < 0).sum())
        hist = np.full(20, 0.5, dtype=np.float64)
        symbols = 10 + res.size
        common = 0xFFFFFFFF
        united = 0x0
        for cls in res:
            hist[cls] += 1.0
            p = _PROPS.get(_ALPHA[cls], 0xFFFFFFFF)
            common &= p
            united |= p
        prop = (bin(common & 0x3FF).count("1") + 10.0
                - bin(united & 0x3FF).count("1")) / 10.0
        ps = hist / symbols
        entropy = float(-(lam * ps * np.log2(ps)).sum())
        gap_score = gap_count / n
        total += (1.0 - entropy) * prop * (1.0 - gap_score)
    return total


def check_acceptance(
    reference: MSA,
    candidate: MSA,
    acceptance_length: bool = True,
    acceptance_entropy: bool = False,
) -> bool:
    """RefinementBase::checkAcceptance (RefinementBase.cpp:99-117)."""
    ok = True
    if acceptance_length:
        ok = ok and reference.length >= candidate.length
    if acceptance_entropy:
        ok = ok and (
            entropy_evaluator(candidate) >= entropy_evaluator(reference)
        )
    return ok


def update_column_scores(
    alignment: MSA, ignore_terminal_gaps: bool = True
) -> list[tuple[int, float]]:
    """ColumnRefinement::updateColumnScores (ColumnRefinement.cpp:128+)
    on a fresh vector, as the JAX package's function of this name.

    Per column, the gap count inside each sequence's non-terminal
    segment; stable-sorted by |N/2 - gaps| descending, zero-gap columns
    dropped.  Returns [(column, gaps)].  The refinement itself keeps the
    reference's stateful vector (`ColumnScoreState`).
    """
    rows = alignment.rows
    n, length = rows.shape
    if length == 0:
        return []
    isgap = rows < 0
    inside = np.ones((n, length), dtype=bool)
    if ignore_terminal_gaps:
        res = ~isgap
        first = res.argmax(axis=1)
        last = length - 1 - res[:, ::-1].argmax(axis=1)
        cols = np.arange(length)[None, :]
        inside = (cols >= first[:, None]) & (cols <= last[:, None])
    gaps = (isgap & inside).sum(axis=0).astype(np.float64)
    keys = -np.abs(n / 2.0 - gaps)
    order = np.lexsort((np.arange(length), keys))   # stable, desc dev
    return [(int(c), float(gaps[c])) for c in order if gaps[c] != 0.0]


class ColumnScoreState:
    """Stateful twin of ColumnRefinement::columnScores.

    The reference NEVER clears the member vector between
    updateColumnScores calls (ColumnRefinement.cpp:131-178): each call
    resizes it — retaining the previously sorted-and-erased entries —
    reassigns .first positionally, and ACCUMULATES the new gap counts
    onto the stale (permuted) .second values, then stable-sorts by
    |N/2 - second| descending and erases zero entries.  The surviving
    accumulated values steer every det_uniform_int draw, so bit-faithful
    statefulness is required for division-column parity."""

    def __init__(self) -> None:
        self.scores: list[list] = []  # [first, second] pairs

    def update(self, alignment: MSA,
               ignore_terminal_gaps: bool = True) -> list[list]:
        rows = alignment.rows
        n, length = rows.shape
        cs = self.scores
        if len(cs) > length:          # vector::resize shrink
            del cs[length:]
        else:                         # ...or grow with (0, 0)
            cs.extend([c, 0.0] for c in range(len(cs), length))
        isgap = rows < 0
        inside = np.ones((n, length), dtype=bool)
        if ignore_terminal_gaps:
            res = ~isgap
            first = res.argmax(axis=1)
            last = length - 1 - res[:, ::-1].argmax(axis=1)
            cols = np.arange(length)[None, :]
            inside = (cols >= first[:, None]) & (cols <= last[:, None])
        gaps = (isgap & inside).sum(axis=0).astype(np.float64)
        for c in range(length):
            cs[c][0] = c
            cs[c][1] += float(gaps[c])
        cs.sort(key=lambda e: -abs(n / 2.0 - e[1]))  # stable desc
        self.scores = [e for e in cs if e[1] != 0.0]
        return self.scores


def _realign_groups(alignment, g1, g2, posts, weights, cutoff,
                    pool=None):
    p1 = alignment.project(g1)
    p2 = alignment.project(g2)
    prof = build_profile_posterior(p1, p2, posts, weights,
                                   cutoff_sub=cutoff, pool=pool)
    path, _ = mwt_path(prof)
    STATS.count("candidates")
    return merge_alignments(p1, p2, path).sort_by_label()


def column_refinement(
    alignment: MSA,
    posts: dict,
    weights: np.ndarray,
    iterations: int = 30,
    cutoff: float = CUTOFF,
    max_depth: int = 0,
    column_fraction: float = 1.0,
    ignore_terminal_gaps: bool = True,
    acceptance_length: bool = True,
    acceptance_entropy: bool = False,
    config_iterations: int = -1,
    num_seqs_total: int | None = None,
    observer=None,
) -> MSA:
    """ColumnRefinement with recursion and exact division-column RNG:
    the reference draws from its own default mt19937 through
    det_uniform_int_distribution (one engine per refinement run).
    """
    n_total = num_seqs_total or alignment.num_seqs
    if alignment.num_seqs < 2:
        return alignment
    eng = qprand.Mt19937Stream()
    depth_cap = min(max_depth, int(math.log2(max(n_total, 1))))
    pool = PostPool(posts)
    state = ColumnScoreState()

    # RefinementBase::operator() -> initialise(): one updateColumnScores
    # call on the starting alignment seeds the stateful score vector and
    # gates the whole loop on hi > 0 (ColumnRefinement.cpp:63-79).
    init_scores = state.update(alignment, ignore_terminal_gaps)
    init_used = int(len(init_scores) * abs(column_fraction))
    if min(max(init_used, config_iterations), len(init_scores)) <= 0:
        return alignment

    def split(sub: MSA):
        scores = state.update(sub, ignore_terminal_gaps)
        used = int(len(scores) * abs(column_fraction))
        if column_fraction > 0:
            lo = 0
            hi = min(max(used, config_iterations), len(scores))
        else:
            lo = max(0, len(scores) - max(used, config_iterations))
            hi = len(scores)
        if hi <= 0 or hi <= lo:
            return None, None
        rnd = eng.det_uniform_int(lo, hi - 1)
        div = min(scores[rnd][0], sub.length - 1)
        g1 = [i for i in range(sub.num_seqs) if sub.rows[i, div] < 0]
        g2 = [i for i in range(sub.num_seqs) if sub.rows[i, div] >= 0]
        return g1, g2

    def refine(sub: MSA, depth: int) -> MSA:
        g1, g2 = split(sub)
        if not g1 or not g2:
            return sub
        p1 = sub.project(g1)
        p2 = sub.project(g2)
        if depth < depth_cap:
            p1 = refine(p1, depth + 1)
            p2 = refine(p2, depth + 1)
        prof = build_profile_posterior(p1, p2, posts, weights,
                                       cutoff_sub=cutoff, pool=pool)
        path, _ = mwt_path(prof)
        candidate = merge_alignments(p1, p2, path).sort_by_label()
        STATS.count("candidates")
        if check_acceptance(sub, candidate, acceptance_length,
                            acceptance_entropy):
            STATS.count("accepted")
            return candidate
        return sub

    for it in range(iterations):
        alignment = refine(alignment, 0)
        if observer is not None:
            observer(alignment, it)
    return alignment


def random_refinement(
    alignment: MSA,
    posts: dict,
    weights: np.ndarray,
    rng: GlibcRand,
    iterations: int,
    cutoff: float = CUTOFF,
    acceptance_length: bool = True,
    acceptance_entropy: bool = False,
    observer=None,
) -> MSA:
    """RandomRefinement: RNG bipartition with acceptance tests."""
    n = alignment.num_seqs
    pool = PostPool(posts)
    for it in range(iterations):
        g1 = [i for i in range(n) if rng.rand() % 2]
        g2 = [i for i in range(n) if i not in set(g1)]
        if not g1 or not g2:
            continue
        candidate = _realign_groups(alignment, g1, g2, posts, weights,
                                    cutoff, pool=pool)
        if check_acceptance(alignment, candidate, acceptance_length,
                            acceptance_entropy):
            STATS.count("accepted")
            alignment = candidate
        if observer is not None:
            observer(alignment, it)
    return alignment


def tree_refinement(
    alignment: MSA,
    posts: dict,
    weights: np.ndarray,
    rng: GlibcRand,
    iterations: int,
    root,
    cutoff: float = CUTOFF,
    acceptance_length: bool = True,
    acceptance_entropy: bool = False,
    observer=None,
) -> MSA:
    """TreeRefinement: cut a random internal edge; realign the sides.

    `observer(alignment, iteration)` is the IRefinementObserver hook
    (ExtendedMSA::iterationDone autosave, ExtendedMSA.cpp:228-236)."""
    from mlprobs_tpu_torch.align.tree import TreeNode, leaves

    internals: list[TreeNode] = []

    def collect(t: TreeNode):
        if not t.leaf:
            if t.parent is not None:
                internals.append(t)
            collect(t.left)
            collect(t.right)

    collect(root)
    n = alignment.num_seqs
    pool = PostPool(posts)
    label_to_row = {int(l): r for r, l in enumerate(alignment.labels)}
    for it in range(iterations):
        if not internals:
            break
        node = internals[rng.rand() % len(internals)]
        g1 = sorted(label_to_row[l] for l in leaves(node))
        g2 = [i for i in range(n) if i not in set(g1)]
        if not g1 or not g2:
            continue
        candidate = _realign_groups(alignment, g1, g2, posts, weights,
                                    cutoff, pool=pool)
        if check_acceptance(alignment, candidate, acceptance_length,
                            acceptance_entropy):
            STATS.count("accepted")
            alignment = candidate
        label_to_row = {int(l): r for r, l in enumerate(alignment.labels)}
        if observer is not None:
            observer(alignment, it)
    return alignment


def entropy_score(alignment: MSA) -> float:
    """The JAX package's name for `entropy_evaluator`."""
    return entropy_evaluator(alignment)
