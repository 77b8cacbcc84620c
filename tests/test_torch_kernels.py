"""The kernel wrappers of the port: their CPU path and, on a card, the
CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on a machine with a GPU and
no JAX:  python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
Tolerances as in tests/test_torch_wavefront.py: sweep planes 1e-5
relative to each row's max after aligning both to one scale, log2 totals
2e-4, posteriors 2e-4, MWT score rtol 1e-4 / atol 1e-3, match counts
exact, top-k values 1e-7 with lanes equal wherever the value is
positive.  The Viterbi and qpx kernels: bit equality over every returned
tensor.  combine's GIVEN kind (`mwt_topk`) over a given plane: top-k
values, scores and match counts bit-equal to `topk_skew` + `mwt_skew`,
lanes equal wherever the value is positive.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlprobs_tpu_torch.align import pairwise as tpw  # noqa: E402
from mlprobs_tpu_torch.ops import wavefront as twf  # noqa: E402
from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as twk  # noqa: E402

MODEL_SETS = {
    "mix": ("hmm5", "partition", "local"),
    "qp": ("hmm5", "partition"),
    "hmm5": ("hmm5",),
    "local": ("local",),
    "partition": ("partition",),
}


def _batch(device, lp=128, b=5, seed=9):
    rng = np.random.default_rng(seed)
    lx = rng.integers(40, 100, size=b).astype(np.int32)
    ly = rng.integers(40, 100, size=b).astype(np.int32)
    X = np.full((b, lp), 20, np.int8)
    Y = np.full((b, lp), 20, np.int8)
    for k in range(b):
        X[k, : lx[k]] = rng.integers(0, 20, lx[k])
        Y[k, : ly[k]] = rng.integers(0, 20, ly[k])
    return tuple(torch.from_numpy(a).to(device) for a in (X, Y, lx, ly))


def _sweeps(fn, X, Y, lx, ly, tf, tr, models):
    lp = X.shape[1]
    z = torch.zeros_like(lx)
    fwd = fn(X, Y, z, z, lx, ly, tf, models=models)
    rev = fn(X.flip(1).contiguous(), Y.flip(1).contiguous(),
             (lp - lx).int(), (lp - ly).int(), lx, ly, tr, models=models,
             emit_pre=True)
    return fwd, rev


@pytest.mark.parametrize("mode", ["mix", "partition"])
def test_cpu_wrappers_run_the_plain_versions(mode):
    """On CPU tensors the wrappers are their plain versions, exactly, and
    launch nothing."""
    models = MODEL_SETS[mode]
    X, Y, lx, ly = _batch("cpu", b=3)
    tf, tr = tpw._wf_tables(mode, 0.17, "cpu")
    twk.reset_launch_counts()
    fk, rk = _sweeps(twk.sweep, X, Y, lx, ly, tf, tr, models)
    fp, rp = _sweeps(twk.sweep_reference, X, Y, lx, ly, tf, tr, models)
    for m in models:
        assert torch.equal(fk["planes"][m], fp["planes"][m])
        assert torch.equal(rk["log2t"][m], rp["log2t"][m])
    out = twk.combine(fk, rk, lx, ly, models, with_matches=True, topk=16)
    ref = twk.combine_reference(fp, rp, lx, ly, models, with_matches=True,
                                topk=16)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert (twk.sweep.launches, twk.combine.launches) == (0, 0)


def test_pack_tables_layout():
    """The packed table block puts each parameter where csrc/sweep.cu
    reads it."""
    tf, _ = tpw._wf_tables("mix", 0.17, "cpu")
    rows = twk.pack_tables(tf, ("hmm5", "local", "partition"), "cpu")
    assert rows.shape == (3, twk.TAB_SIZE)
    assert torch.equal(rows[0, :441], tf["hmm5"]["pm"].reshape(-1))
    assert torch.equal(rows[0, 448:490], tf["hmm5"]["pins"].reshape(-1))
    assert torch.equal(rows[0, 496:521], tf["hmm5"]["T"].reshape(-1))
    assert torch.equal(rows[0, 528:533], tf["hmm5"]["init"])
    assert torch.equal(rows[1, 496:505], tf["local"]["T"].reshape(-1))
    assert rows[1, 536] == tf["local"]["c1"]
    assert rows[1, 537] == tf["local"]["c2"]
    assert rows[2, 538] == tf["partition"]["go"]
    assert rows[2, 539] == tf["partition"]["ge"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODEL_SETS))
def test_kernels_match_plain_on_card(cuda_device, mode):
    """sweep and combine against their plain versions on the same card
    inputs (chip_smoke.py runs the same checks at the main path's
    shapes)."""
    models = MODEL_SETS[mode]
    X, Y, lx, ly = _batch(cuda_device)
    tf, tr = tpw._wf_tables(mode, 0.17, cuda_device)
    fk, rk = _sweeps(twk.sweep, X, Y, lx, ly, tf, tr, models)
    fp, rp = _sweeps(twk.sweep_reference, X, Y, lx, ly, tf, tr, models)
    for m in models:
        for k, p in ((fk, fp), (rk, rp)):
            a = k["planes"][m] * torch.exp2(
                p["scales"][m] - k["scales"][m])[:, :, None]
            rowmax = p["planes"][m].abs().amax(dim=2).clamp(min=1e-38)
            err = (a - p["planes"][m]).abs().amax(dim=2) / rowmax
            assert float(err.max()) <= 1e-5
            assert float((k["log2t"][m] - p["log2t"][m]).abs().max()) <= 2e-4
    post, score, nb = twk.combine(fk, rk, lx, ly, models, with_matches=True)
    post_p, score_p, nb_p = twk.combine_reference(fk, rk, lx, ly, models,
                                                  with_matches=True)
    assert float((post - post_p).abs().max()) <= 2e-4
    torch.testing.assert_close(score, score_p, rtol=1e-4, atol=1e-3)
    assert torch.equal(nb, nb_p)
    vals, lanes, _ = twk.combine(fk, rk, lx, ly, models, topk=16)
    vw, lw = twf.topk_skew(post, 16, 0.01)
    assert float((vals - vw).abs().max()) <= 1e-7
    assert torch.equal(lanes[vw > 0], lw[vw > 0])


def _edge_batch(device, lp, b, seed):
    """b pairs padded to lp, the first with x of full length, the last
    with y of full length, the rest of random lengths in [lp/2, lp]."""
    rng = np.random.default_rng(seed)
    lx = rng.integers(max(1, lp // 2), lp + 1, size=b).astype(np.int32)
    ly = rng.integers(max(1, lp // 2), lp + 1, size=b).astype(np.int32)
    lx[0] = ly[-1] = lp
    X = np.full((b, lp), 20, np.int8)
    Y = np.full((b, lp), 20, np.int8)
    for k in range(b):
        X[k, : lx[k]] = rng.integers(0, 20, lx[k])
        Y[k, : ly[k]] = rng.integers(0, 20, ly[k])
    return tuple(torch.from_numpy(a).to(device) for a in (X, Y, lx, ly))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("lp", [1, 31, 32, 33, 127, 129, 511, 513, 1100])
@pytest.mark.parametrize("mode", list(MODEL_SETS))
def test_sweep_lane_edges_on_card(cuda_device, mode, lp, b):
    """The sweep against its plain version at the edges of the kernel's
    lane mapping (a warp's and a block's lanes, past 1,024 lanes), both
    passes: scales equal, planes within 1e-5 of their row's max, log2
    totals within 2e-4."""
    models = MODEL_SETS[mode]
    X, Y, lx, ly = _edge_batch(cuda_device, lp, b, seed=lp * 7 + b)
    tf, tr = tpw._wf_tables(mode, 0.17, cuda_device)
    fk, rk = _sweeps(twk.sweep, X, Y, lx, ly, tf, tr, models)
    fp, rp = _sweeps(twk.sweep_reference, X, Y, lx, ly, tf, tr, models)
    for m in models:
        for k, p in ((fk, fp), (rk, rp)):
            assert torch.equal(k["scales"][m], p["scales"][m])
            rowmax = p["planes"][m].abs().amax(dim=2).clamp(min=1e-38)
            err = (k["planes"][m] - p["planes"][m]).abs().amax(dim=2)
            assert float((err / rowmax).max()) <= 1e-5
            assert float((k["log2t"][m] - p["log2t"][m]).abs().max()) <= 2e-4


def _l2t_tol(l2t):
    """2e-4, or 1e-6 of the total's magnitude where that is larger: the
    local model's log2 total is a log-sum over 2Lp+1 diagonals in f32,
    which the plain version adds one diagonal at a time and the kernel 32
    at a time, and past |l2t| = 2,048 one f32 step is 2.4e-4."""
    return torch.clamp(l2t.abs() * 1e-6, min=2e-4)


def _sweeps_vs_plain(fk, rk, fp, rp, models):
    """Scales equal, planes within 1e-5 of their row's max, log2 totals
    within _l2t_tol."""
    for m in models:
        for k, p in ((fk, fp), (rk, rp)):
            assert torch.equal(k["scales"][m], p["scales"][m])
            rowmax = p["planes"][m].abs().amax(dim=2).clamp(min=1e-38)
            err = (k["planes"][m] - p["planes"][m]).abs().amax(dim=2)
            assert float((err / rowmax).max()) <= 1e-5
            dl = (k["log2t"][m] - p["log2t"][m]).abs()
            assert bool((dl <= _l2t_tol(p["log2t"][m])).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lp", [8192, 8320])
def test_local_log2_total_on_card(cuda_device, lp):
    """The local model's log2 total on both sides of the short instances'
    last length, three pairs (x full, y full, both shorter), both passes:
    the kernel adds the diagonals' terms in the plain version's order, so
    the totals agree to _l2t_tol; scales and planes as in
    test_sweep_cluster_edges_on_card."""
    models = MODEL_SETS["local"]
    X, Y, lx, ly = _edge_batch(cuda_device, lp, 3, seed=lp * 5 + 1)
    tf, tr = tpw._wf_tables("local", 0.17, cuda_device)
    fk, rk = _sweeps(twk.sweep, X, Y, lx, ly, tf, tr, models)
    fp, rp = _sweeps(twk.sweep_reference, X, Y, lx, ly, tf, tr, models)
    _sweeps_vs_plain(fk, rk, fp, rp, models)


@pytest.mark.cuda
@pytest.mark.parametrize("lp", [2049, 4097, 8064])
def test_sweep_cluster_edges_on_card(cuda_device, lp):
    """The sweep against its plain version in clusters of 3, 5 and 8
    blocks (Lp 2,049, 4,097 and 8,064, three pairs: x of full length, y
    of full length, both shorter), both passes, all three models in one
    launch (each model's blocks run the code of its own kind alone)."""
    models = MODEL_SETS["mix"]
    X, Y, lx, ly = _edge_batch(cuda_device, lp, 3, seed=lp * 7 + 3)
    tf, tr = tpw._wf_tables("mix", 0.17, cuda_device)
    fk, rk = _sweeps(twk.sweep, X, Y, lx, ly, tf, tr, models)
    fp, rp = _sweeps(twk.sweep_reference, X, Y, lx, ly, tf, tr, models)
    _sweeps_vs_plain(fk, rk, fp, rp, models)


def _combine_vs_plain(fk, rk, lx, ly, models, topks=(1, 16), cutoff=0.01):
    """combine against combine_reference on the same (kernel) sweeps:
    dense + match counts; then the fused top-k for each k in `topks`
    at `cutoff`, without and with match counts (the NP path's mode),
    against `topk_skew` of the kernel's own dense plane, as
    test_kernels_match_plain_on_card holds it (the two planes may differ
    in the last bit, which could reorder near-equal values)."""
    post, score, nb = twk.combine(fk, rk, lx, ly, models, with_matches=True)
    post_p, score_p, nb_p = twk.combine_reference(fk, rk, lx, ly, models,
                                                  with_matches=True)
    assert float((post - post_p).abs().max()) <= 2e-4
    D, _, W = post.shape
    d = torch.arange(D, device=post.device)[:, None, None]
    j = torch.arange(W, device=post.device)[None, None, :]
    grid = ((j >= 1) & (j <= ly[None, :, None]) & (d - j >= 1)
            & (d - j <= lx[None, :, None]))
    assert int((post[~grid] != 0).sum()) == 0
    torch.testing.assert_close(score, score_p, rtol=1e-4, atol=1e-3)
    assert torch.equal(nb, nb_p)
    for k in topks:
        k = min(k, W)
        vw, lw = twf.topk_skew(post, k, cutoff)
        for wm in (False, True):
            vals, lanes, sc_t, *nb_t = twk.combine(
                fk, rk, lx, ly, models, with_matches=wm, topk=k,
                cutoff=cutoff)
            assert float((vals - vw).abs().max()) <= 1e-7
            assert torch.equal(lanes[vw > 0], lw[vw > 0])
            assert torch.equal(sc_t, score)
            if wm:
                assert torch.equal(nb_t[0], nb)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("lp", [1, 31, 32, 33, 127, 129, 511, 513, 1100,
                                4100])
@pytest.mark.parametrize("mode", list(MODEL_SETS))
def test_combine_lane_edges_on_card(cuda_device, mode, lp, b):
    """combine against its plain version at the edges of its lane mapping
    (a warp's lanes, 4, 8 and 16 lanes a thread, and at Lp = 4,100 past
    the one-block design: a cluster of 11 blocks), x or y of full length
    so the MWT terminal sits on the last lane and the last diagonal:
    dense plane within 2e-4 and exact zeros outside the grid, score rtol
    1e-4 / atol 1e-3, match counts exact, top-k 1 and 16 values within
    1e-7 and lanes equal wherever the value is positive."""
    models = MODEL_SETS[mode]
    X, Y, lx, ly = _edge_batch(cuda_device, lp, b, seed=lp * 11 + b)
    tf, tr = tpw._wf_tables(mode, 0.17, cuda_device)
    fk, rk = _sweeps(twk.sweep, X, Y, lx, ly, tf, tr, models)
    _combine_vs_plain(fk, rk, lx, ly, models)


@pytest.mark.cuda
@pytest.mark.parametrize("cutoff", [0.01, 0.0])
@pytest.mark.parametrize("mode", list(MODEL_SETS))
def test_combine_topk_ties_on_card(cuda_device, mode, cutoff):
    """Pairs with x = y (a homopolymer and a repeated motif): mirror cells
    of an anti-diagonal hold equal posteriors, so equal values compete
    for the top-k and the lowest lane must come first.  At cutoff 0 every
    positive lane is a candidate, far more than a warp's 32."""
    lp = 160
    x = np.stack([np.full(lp, 3, np.int8),
                  np.tile(np.array([1, 5, 9], np.int8), lp)[:lp]])
    X = torch.from_numpy(x).to(cuda_device)
    lx = torch.full((2,), lp, dtype=torch.int32, device=cuda_device)
    tf, tr = tpw._wf_tables(mode, 0.17, cuda_device)
    models = MODEL_SETS[mode]
    fk, rk = _sweeps(twk.sweep, X, X.clone(), lx, lx.clone(), tf, tr, models)
    _combine_vs_plain(fk, rk, lx, lx.clone(), models, cutoff=cutoff)


def _swap_xy(X, Y, lx, ly):
    """The same pairs with x and y exchanged (y of full length, x
    shorter)."""
    return Y.contiguous(), X.contiguous(), ly.clone(), lx.clone()


@pytest.mark.cuda
@pytest.mark.parametrize("mode,lp,b,swap", [
    ("mix", 8192, 1, False), ("mix", 8193, 1, False),
    ("mix", 12288, 1, False), ("mix", 16384, 1, False),
    ("hmm5", 16385, 1, True), ("mix", 8320, 3, False),
    ("qp", 8320, 1, False), ("qp", 8320, 1, True), ("hmm5", 16512, 2, False),
    ("hmm5", 8320, 1, False), ("local", 8320, 1, False),
    ("partition", 8320, 1, False),
])
def test_kernels_past_8192_lanes_on_card(cuda_device, mode, lp, b, swap):
    """Both kernels past the short instances' lengths, x of full length
    and y shorter (swap: the reverse; B > 1: the first pair x full, the
    last y full, several clusters at once): Lp = 8,192, the sweep's short
    instance's last (a cluster of 8 at 4 lanes a thread), and 8,193, its
    long instance's first (9 blocks); 16,384 and 16,385, the long
    instance's last at 4 lanes a thread (16 blocks) and first at 8 (9);
    combine on a cluster of 13 to 16 blocks throughout: the sweep as in
    test_sweep_cluster_edges_on_card, combine as in
    test_combine_lane_edges_on_card."""
    models = MODEL_SETS[mode]
    X, Y, lx, ly = _edge_batch(cuda_device, lp, max(b, 2),
                               seed=lp + len(models))
    if b == 1:
        X, Y, lx, ly = (t[:1].contiguous() for t in (X, Y, lx, ly))
    if swap:
        X, Y, lx, ly = _swap_xy(X, Y, lx, ly)
    tf, tr = tpw._wf_tables(mode, 0.17, cuda_device)
    fk, rk = _sweeps(twk.sweep, X, Y, lx, ly, tf, tr, models)
    fp, rp = _sweeps(twk.sweep_reference, X, Y, lx, ly, tf, tr, models)
    _sweeps_vs_plain(fk, rk, fp, rp, models)
    del fp, rp
    _combine_vs_plain(fk, rk, lx, ly, models)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,lp,b", [
    ("mix", 4096, 1), ("mix", 4097, 1), ("mix", 4097, 3), ("qp", 6144, 2),
    ("mix", 16512, 1), ("mix", 24704, 1),
])
def test_combine_ring_rows_on_card(cuda_device, mode, lp, b):
    """combine on both sides of its crossover (Lp = 4,096: one block a
    pair, a ring of 6 rows; 4,097: a cluster of 11 blocks at 4 lanes a
    thread, B = 1 and 3), on 16 blocks at B = 2 (Lp = 6,144), and at the
    lengths where the one-block design's ring held two rows (16,512) and
    one (24,704), now clusters at 8 lanes a thread.  Dense with match
    counts against combine_reference on the same kernel sweeps, then
    top-k 16 with match counts against topk_skew of the kernel's dense
    plane, as _combine_vs_plain holds them.  At Lp = 24,704 the six f32
    sweep planes are 29 GB; past it the plain version's posterior
    temporaries would not fit, and test_combine_plan_edges_on_card holds
    the DP and the top-k there."""
    models = MODEL_SETS[mode]
    X, Y, lx, ly = _edge_batch(cuda_device, lp, max(b, 2), seed=lp + 3)
    if b == 1:
        X, Y, lx, ly = (t[:1].contiguous() for t in (X, Y, lx, ly))
    tf, tr = tpw._wf_tables(mode, 0.17, cuda_device)
    fk, rk = _sweeps(twk.sweep, X, Y, lx, ly, tf, tr, models)
    post, score, nb = twk.combine(fk, rk, lx, ly, models, with_matches=True)
    post_p, score_p, nb_p = twk.combine_reference(fk, rk, lx, ly, models,
                                                  with_matches=True)
    assert float((post - post_p).abs().max()) <= 2e-4
    del post_p
    torch.testing.assert_close(score, score_p, rtol=1e-4, atol=1e-3)
    assert torch.equal(nb, nb_p)
    vw, lw = _topk_rows(post, 16, 0.01)
    del post
    vals, lanes, sc_t, nb_t = twk.combine(fk, rk, lx, ly, models,
                                          with_matches=True, topk=16,
                                          cutoff=0.01)
    assert float((vals - vw).abs().max()) <= 1e-7
    assert torch.equal(lanes[vw > 0], lw[vw > 0])
    assert torch.equal(sc_t, score)
    assert torch.equal(nb_t, nb)


def _topk_rows(post, k, cutoff, rows=2048):
    """topk_skew of a plane, a slab of diagonals at a time (each row is
    ranked alone; the sort of a whole long plane would need several times
    its memory)."""
    parts = [twf.topk_skew(post[a:a + rows], k, cutoff)
             for a in range(0, post.shape[0], rows)]
    return (torch.cat([v for v, _ in parts]),
            torch.cat([ln for _, ln in parts]))


def _plan_edges(plan, lo, hi, key):
    """The first and the last Lp in [lo, hi] of each run of equal
    key(plan(Lp)): each cluster size's first and last length, a tier of
    lanes a thread at a time."""
    edges, prev = [], None
    for lp in range(lo, hi + 1):
        k = key(plan(lp))
        if k != prev:
            if prev is not None:
                edges.append(lp - 1)
            edges.append(lp)
            prev = k
    edges.append(hi)
    return sorted(set(edges))


@functools.lru_cache(maxsize=None)
def _sweep_edges():
    return _plan_edges(twk.sweep_plan, twk.SWEEP_LONG_FROM - 1,
                       twk.SWEEP_MAX_LP, lambda p: (p.lpt, p.maxt, p.blocks))


@functools.lru_cache(maxsize=None)
def _combine_edges():
    return _plan_edges(lambda lp: twk.combine_plan(lp, 16),
                       twk.COMBINE_CLUSTER_FROM - 1, twk.COMBINE_MAX_LP,
                       lambda p: (p.lpt, p.blocks))


@pytest.mark.cuda
@pytest.mark.parametrize("lp", _sweep_edges())
def test_sweep_plan_edges_on_card(cuda_device, lp, monkeypatch):
    """The sweep at the first and the last length of each cluster size of
    each tier of its long instance (and at the short instance's last),
    up to the largest Lp it takes (49,152): one pair, x of full length,
    the forward pass of one model (hmm5, local or partition by Lp mod 3;
    the lane mapping does not depend on the model).  Up to 32,768 lanes
    against the same sweep under another plan (the long instance at 8
    lanes a thread in blocks of up to 384 threads; at 8,192 the long
    instance against the short one), bit for bit: planes, scales and the
    hmm5 and partition totals (the local total sums its rows in other
    groups, so within _l2t_tol).  The top tier (8 lanes a thread, blocks
    of up to 384 threads, past 32,768 lanes), which no other plan takes,
    against the plain version: scales equal, planes within 1e-5 of their
    row's max, the total within _l2t_tol.  At Lp = 49,152 the two planes
    are 19.3 GB each."""
    model = ("hmm5", "local", "partition")[lp % 3]
    X, Y, lx, ly = (t[:1].contiguous() for t in _edge_batch(
        cuda_device, lp, 2, seed=lp * 3 + 1))
    tf, _ = tpw._wf_tables("mix", 0.17, cuda_device)
    z = torch.zeros_like(lx)
    plan = twk.sweep_plan(lp)
    k = twk.sweep(X, Y, z, z, lx, ly, tf, models=(model,))
    if plan.maxt == twk._SWEEP_LONG_TIERS[-1][1]:
        p = twk.sweep_reference(X, Y, z, z, lx, ly, tf, models=(model,))
        assert torch.equal(k["scales"][model], p["scales"][model])
        for a in range(0, 2 * lp + 1, 4096):
            kp = k["planes"][model][a:a + 4096]
            pp = p["planes"][model][a:a + 4096]
            rowmax = pp.abs().amax(dim=2).clamp(min=1e-38)
            assert float(((kp - pp).abs().amax(dim=2) / rowmax).max()) \
                <= 1e-5
        dl = (k["log2t"][model] - p["log2t"][model]).abs()
        assert bool((dl <= _l2t_tol(p["log2t"][model])).all())
        return
    if plan.instance == 0:
        monkeypatch.setattr(twk, "SWEEP_LONG_FROM", 1)
    else:
        monkeypatch.setattr(twk, "_SWEEP_LONG_TIERS",
                            twk._SWEEP_LONG_TIERS[-1:])
    assert twk.sweep_plan(lp) != plan
    p = twk.sweep(X, Y, z, z, lx, ly, tf, models=(model,))
    assert torch.equal(k["scales"][model], p["scales"][model])
    assert torch.equal(k["planes"][model], p["planes"][model])
    if model == "local":
        dl = (k["log2t"][model] - p["log2t"][model]).abs()
        assert bool((dl <= _l2t_tol(p["log2t"][model])).all())
    else:
        assert torch.equal(k["log2t"][model], p["log2t"][model])


@pytest.mark.cuda
@pytest.mark.parametrize("lp", [128, 512])
def test_qp_scaled_tables_on_card(cuda_device, lp):
    """The scaled-kernel qp route (MLPROBS_QP_EXACT=0): both kernels on
    hmm5 + partition with the Vtml200 ("qp") partition tables, against
    their plain versions: sweep scales equal and planes and totals as in
    _sweeps_vs_plain; combine dense with match counts, top-k 1 and 16
    with and without match counts, as in _combine_vs_plain."""
    models = MODEL_SETS["qp"]
    tf, tr = tpw._wf_tables("qp", None, cuda_device)
    qp_pm = torch.exp(torch.as_tensor(
        tpw.mp.partition_params_qp().lscore, device=cuda_device))
    assert torch.equal(tf["partition"]["pm"][:20, :20], qp_pm[:20, :20])
    X, Y, lx, ly = _edge_batch(cuda_device, lp, 4, seed=lp * 13 + 5)
    fk, rk = _sweeps(twk.sweep, X, Y, lx, ly, tf, tr, models)
    fp, rp = _sweeps(twk.sweep_reference, X, Y, lx, ly, tf, tr, models)
    _sweeps_vs_plain(fk, rk, fp, rp, models)
    _combine_vs_plain(fk, rk, lx, ly, models)


# ---------------------------------------------------------------------------
# The feature pass's Viterbi kernel and the qpx forward/backward kernels
# (csrc/viterbi.cu, csrc/qpx.cu): both replay their plain versions' f32
# arithmetic op for op, so every returned tensor is held bit for bit.
# ---------------------------------------------------------------------------

from mlprobs_tpu_torch.ops import qpx as tqpx  # noqa: E402
from mlprobs_tpu_torch.ops.kernels import build as tbuild  # noqa: E402
from mlprobs_tpu_torch.ops.kernels import qpx_kernel as tqk  # noqa: E402
from mlprobs_tpu_torch.ops.kernels import viterbi_kernel as tvk  # noqa: E402

VIT_OUT = ("dirs", "end_state", "score", "pathlen", "matches", "scores_rev")
QPX_OUT = ("fwd_m", "bwd_m", "total")


def _viterbi_tables(device):
    return tpw.viterbi_tables(tpw.mp.blosum62(), device)


def _assert_bit_equal(names, got, want):
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("lp,b", [(1, 3), (33, 3), (128, 8)])
def test_feature_wrappers_run_the_plain_versions_on_cpu(lp, b):
    """On CPU tensors the Viterbi and qpx wrappers are their plain
    versions, exactly, and launch nothing."""
    X, Y, lx, ly = _edge_batch("cpu", lp, b, seed=lp * 3 + b)
    twk.reset_launch_counts()
    tabs = _viterbi_tables("cpu")
    _assert_bit_equal(VIT_OUT, tvk.viterbi_stats(X, Y, lx, ly, *tabs),
                      tvk.viterbi_reference(X, Y, lx, ly, *tabs))
    p5 = tpw._qpx_params(torch.device("cpu"))
    _assert_bit_equal(QPX_OUT, tqk.hmm5_fb(X, Y, lx, ly, *p5),
                      tqpx.hmm5_fb_qpx(X, Y, lx, ly, *p5))
    assert torch.equal(tqk.hmm5_posterior(X, Y, lx, ly, *p5),
                       tqpx.hmm5_posterior_qpx(X, Y, lx, ly, *p5))
    assert (tvk.viterbi_stats.launches, tqk.hmm5_fb.launches) == (0, 0)


def test_feature_table_blocks_layout():
    """The packed table blocks put each parameter where csrc/viterbi.cu
    and csrc/qpx.cu read it."""
    pl, vinit, bl = _viterbi_tables("cpu")
    tab = tvk.pack_tables(pl, vinit, bl, "cpu")
    assert tab.shape == (tvk.TAB_SIZE,)
    lm = tab[:441].reshape(21, 21)
    assert torch.equal(lm[:20, :20], pl["lmatch"][:20, :20])
    assert bool((lm[20] == twf.LOG_ZERO).all())
    assert bool((lm[:, 20] == twf.LOG_ZERO).all())
    assert torch.equal(tab[441:461], pl["lins"][:20])
    assert tab[461] == twf.LOG_ZERO
    assert torch.equal(tab[462:471], pl["trans"].reshape(-1))
    assert torch.equal(tab[471:474], vinit)
    assert torch.equal(tab[474:], bl.reshape(-1))
    p5 = tpw._qpx_params(torch.device("cpu"))
    init, trans, lmatch, lins = p5
    q = tqk.pack_tables(*p5)
    assert q.shape == (tqk.TAB_SIZE,)
    lm22 = q[:484].reshape(22, 22)
    assert torch.equal(lm22[:21, :21], lmatch)
    assert bool((lm22[21] == tqpx.LOG_ZERO).all())
    assert torch.equal(q[484:528].reshape(2, 22)[:, :21], lins.T)
    assert torch.equal(q[528:553], trans.reshape(-1))
    assert torch.equal(q[553:558], init)
    assert torch.equal(q[558:561], torch.tensor([1.0, 2.5, 4.5]))
    assert torch.equal(q[561:577], tqpx._consts(torch.device("cpu"))["lc"]
                       .reshape(-1))


def _bad_feature_args(case, which):
    """Arguments on the meta device, one of them wrong as `case` says."""
    meta = torch.device("meta")
    b, lp = 3, 16
    X = torch.empty((b, lp), dtype=torch.int8, device=meta)
    Y = torch.empty((b, lp), dtype=torch.int8, device=meta)
    lx = torch.empty((b,), dtype=torch.int32, device=meta)
    ly = torch.empty((b,), dtype=torch.int32, device=meta)
    if which == "viterbi":
        pl, vinit, bl = _viterbi_tables(meta)
        tabs = [pl, vinit, bl]
    else:
        tabs = [t.to(meta) for t in tpw._qpx_params(torch.device("cpu"))]
    if case == "dtype":
        X = X.to(torch.int32)
    elif case == "noncontiguous":
        Y = torch.empty((b, 2 * lp), dtype=torch.int8, device=meta)[:, ::2]
    elif case == "table_device":
        k = 1 if which == "viterbi" else 2
        tabs[k] = torch.zeros(tabs[k].shape, dtype=tabs[k].dtype)
    elif case == "batch":
        ly = torch.empty((b + 1,), dtype=torch.int32, device=meta)
    return (X, Y, lx, ly, *tabs)


@pytest.mark.parametrize("case", ["dtype", "noncontiguous", "table_device",
                                  "batch"])
@pytest.mark.parametrize("which", ["viterbi", "qpx"])
def test_feature_wrappers_reject_bad_arguments(monkeypatch, which, case):
    """A tensor the kernel does not take raises KernelArgumentError before
    any launch: a wrong dtype, a non-contiguous tensor, a table on
    another device, a length vector of another batch size."""
    monkeypatch.setattr(tbuild, "lib", lambda name: None)
    fn = tvk.viterbi_stats if which == "viterbi" else tqk.hmm5_fb
    before = (tvk.viterbi_stats.launches, tqk.hmm5_fb.launches)
    with pytest.raises(tbuild.KernelArgumentError):
        fn(*_bad_feature_args(case, which))
    assert (tvk.viterbi_stats.launches, tqk.hmm5_fb.launches) == before


def _vit_lengths():
    # lane edges of csrc/viterbi.cu (4 lanes a thread, lane 0 beside the
    # first thread's lanes 1-4, a warp's strip of 128 lanes, 16 warps a
    # block, more strips in rounds): every remainder of Lp by 4, one strip
    # and the next (Lp = 128, 129, 130), the main shape and a batch around
    # the card's 132 SMs, 16 strips in one round (Lp = 2,048) and 17 in two
    # (2,049), 32 strips in two rounds and 33 in three (4,096, 4,097), the
    # long family's Lp at B = 1 and 2, and 128 strips in 8 rounds (16,384)
    return [(1, 3), (2, 3), (3, 3), (4, 3), (5, 3), (62, 4), (63, 4),
            (64, 4), (65, 4), (127, 3), (128, 8), (129, 3), (130, 3),
            (512, 256), (512, 131), (512, 132), (512, 133), (1023, 2),
            (2047, 1), (2048, 1), (2049, 1), (4095, 1), (4096, 1),
            (4097, 1), (8320, 1), (8320, 2), (16384, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("lp,b", _vit_lengths())
def test_viterbi_kernel_bit_equal_on_card(cuda_device, lp, b):
    """The Viterbi kernel against viterbi_wavefront + viterbi_path_stats
    on the same card inputs, ragged lengths (x of full length in the
    first pair, y in the last): every returned tensor equal bit for bit,
    and one launch counted."""
    X, Y, lx, ly = _edge_batch(cuda_device, lp, b, seed=lp * 17 + b)
    tabs = _viterbi_tables(cuda_device)
    n = tvk.viterbi_stats.launches
    got = tvk.viterbi_stats(X, Y, lx, ly, *tabs)
    assert tvk.viterbi_stats.launches == n + 1
    _assert_bit_equal(VIT_OUT, got,
                      tvk.viterbi_reference(X, Y, lx, ly, *tabs))


def _walk_batch(device, kind, lp, b, seed):
    """(X, Y, lx, ly) where the traceback wraps or ties decide: "empty"
    (lx = 0 or ly = 0), "ones" (lengths 0 to 2), "repeat" (one residue
    repeated: equal scores everywhere), "short" (Lp far above both
    lengths)."""
    rng = np.random.default_rng(seed)
    if kind == "empty":
        lx = rng.integers(0, lp + 1, size=b)
        ly = rng.integers(0, lp + 1, size=b)
        lx[::2] = 0
        ly[1::2] = 0
        lx[-1] = ly[-1] = 0
    elif kind == "ones":
        lx = rng.integers(0, 3, size=b)
        ly = rng.integers(0, 3, size=b)
        lx[0] = ly[0] = 1
    elif kind == "short":
        lx = rng.integers(1, max(2, lp // 16), size=b)
        ly = rng.integers(1, max(2, lp // 16), size=b)
    else:
        lx = rng.integers(max(1, lp // 2), lp + 1, size=b)
        ly = rng.integers(max(1, lp // 2), lp + 1, size=b)
        lx[0] = ly[-1] = lp
    lx, ly = np.minimum(lx, lp), np.minimum(ly, lp)
    X = np.full((b, lp), 20, np.int8)
    Y = np.full((b, lp), 20, np.int8)
    for k in range(b):
        if kind == "repeat":
            X[k, : lx[k]] = Y[k, : ly[k]] = rng.integers(0, 20)
        else:
            X[k, : lx[k]] = rng.integers(0, 20, lx[k])
            Y[k, : ly[k]] = rng.integers(0, 20, ly[k])
    return tuple(torch.from_numpy(a).to(device)
                 for a in (X, Y, lx.astype(np.int32), ly.astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,lp,b", [
    ("empty", 64, 8), ("empty", 512, 6), ("ones", 1, 4), ("ones", 130, 8),
    ("repeat", 129, 4), ("repeat", 512, 3), ("short", 512, 8),
    ("short", 2049, 2)])
def test_viterbi_kernel_walk_wraps_and_ties_on_card(cuda_device, kind, lp,
                                                    b):
    """The Viterbi kernel against its plain version where the walk leaves
    the pair's rectangle (its indices wrap as torch's do) or equal scores
    decide the direction bits: every returned tensor equal bit for bit,
    and one launch counted."""
    X, Y, lx, ly = _walk_batch(cuda_device, kind, lp, b, seed=lp * 23 + b)
    tabs = _viterbi_tables(cuda_device)
    n = tvk.viterbi_stats.launches
    got = tvk.viterbi_stats(X, Y, lx, ly, *tabs)
    assert tvk.viterbi_stats.launches == n + 1
    _assert_bit_equal(VIT_OUT, got,
                      tvk.viterbi_reference(X, Y, lx, ly, *tabs))


def _qpx_lengths():
    # lane edges of csrc/qpx.cu: as _vit_lengths, the ring leaving shared
    # memory past 2,048 lanes, there with more pairs than the card has
    # SMs; the plain version's loop bounds the longest (Lp = 4,100: ~30 s
    # of plain torch on the card)
    return [(1, 3), (2, 3), (63, 4), (64, 4), (65, 4), (128, 8),
            (512, 256), (1023, 2), (2047, 1), (2048, 1), (2049, 140),
            (4100, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("lp,b", _qpx_lengths())
def test_qpx_kernel_bit_equal_on_card(cuda_device, lp, b):
    """The qpx kernels against hmm5_fb_qpx on the same card inputs,
    ragged lengths: fwd_m, bwd_m and the totals equal bit for bit, and
    the posterior of hmm5_posterior_qpx as well."""
    X, Y, lx, ly = _edge_batch(cuda_device, lp, b, seed=lp * 19 + b)
    p5 = tpw._qpx_params(cuda_device)
    n = tqk.hmm5_fb.launches
    got = tqk.hmm5_fb(X, Y, lx, ly, *p5)
    assert tqk.hmm5_fb.launches == n + 1
    want = tqpx.hmm5_fb_qpx(X, Y, lx, ly, *p5)
    _assert_bit_equal(QPX_OUT, got, want)
    post = tqpx.posterior_from_fb(*got, lx, ly)
    del got, want
    assert torch.equal(post, tqpx.hmm5_posterior_qpx(X, Y, lx, ly, *p5))


def _given_lengths():
    # combine's lane mapping (one DP warp up to Lp = 512, more DP warps of
    # 16 lanes a thread up to 4,096, a cluster of blocks past it, several
    # clusters at once at B = 2 and 3) and the realigner's qp batch
    # (Lp = 512, B = 256)
    return [(1, 3), (2, 3), (63, 4), (64, 4), (65, 4), (512, 256),
            (1023, 3), (2047, 2), (4096, 2), (4097, 2), (4097, 3),
            (8192, 1), (8320, 1), (8320, 2), (16384, 1)]


def _given_plane(device, lp, b, seed, kind):
    """(post (D, B, W), lx, ly) for combine's GIVEN kind.  "ties": a few
    values a diagonal (fewer than a warp's 32 candidates), each one of
    four levels, so equal values compete for the top-k; "noise": dense
    values, half of them at the same levels, and uniform noise in every
    cell outside each pair's grid (lane 0, i < 1, past lx and ly), which
    the MWT must not read and the top-k must rank."""
    rng = np.random.default_rng(seed)
    lx = rng.integers(max(1, lp // 2), lp + 1, size=b).astype(np.int32)
    ly = rng.integers(max(1, lp // 2), lp + 1, size=b).astype(np.int32)
    lx[0] = ly[-1] = lp
    lx, ly = (torch.from_numpy(a).to(device) for a in (lx, ly))
    g = torch.Generator(device=device).manual_seed(seed)
    D, W = 2 * lp + 1, lp + 1
    shape = (D, b, W)
    d = torch.arange(D, device=device)[:, None, None]
    j = torch.arange(W, device=device)[None, None, :]
    grid = ((j >= 1) & (j <= ly[None, :, None]) & (d - j >= 1)
            & (d - j <= lx[None, :, None]))
    levels = torch.tensor([0.125, 0.25, 0.375, 0.5], device=device)
    level = levels[torch.randint(0, 4, shape, generator=g, device=device)]
    if kind == "ties":
        keep = torch.rand(shape, generator=g, device=device) < 8.0 / W
        post = torch.where(grid & keep, level, 0.0)
    else:
        val = torch.where(torch.rand(shape, generator=g, device=device)
                          < 0.5, level,
                          torch.rand(shape, generator=g, device=device))
        keep = torch.rand(shape, generator=g, device=device) < 0.3
        post = torch.where(grid, torch.where(keep, val, 0.0),
                           torch.rand(shape, generator=g, device=device))
    return post.contiguous(), lx, ly


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ties", "noise"])
@pytest.mark.parametrize("lp,b", _given_lengths())
def test_combine_given_mode_on_card(cuda_device, lp, b, kind):
    """combine's GIVEN kind (`mwt_topk`) against `topk_skew` + `mwt_skew`
    on the same card plane: dense, top-k 1 and 16, each without and with
    match counts; values and scores equal bit for bit, match counts
    exact, lanes equal wherever the value is positive; one launch a call,
    counted in combine's launches."""
    post, lx, ly = _given_plane(cuda_device, lp, b, lp * 29 + b, kind)
    before = post.clone()
    score_p, nb_p = twf.mwt_skew(post, lx, ly, with_matches=True)
    assert torch.equal(twf.mwt_skew(post, lx, ly), score_p)
    for k in (0, 1, 16):
        k = min(k, lp + 1)
        if k:
            vw, lw = twf.topk_skew(post, k, 0.01)
        for wm in (False, True):
            n = twk.combine.launches
            out = twk.mwt_topk(post, lx, ly, with_matches=wm, topk=k,
                               cutoff=0.01)
            assert twk.combine.launches == n + 1
            assert len(out) == (2 if k else 0) + 1 + wm
            if k:
                vals, lanes = out[:2]
                assert torch.equal(vals, vw)
                assert torch.equal(lanes[vw > 0], lw[vw > 0])
            assert torch.equal(out[2 if k else 0], score_p)
            if wm:
                assert torch.equal(out[-1], nb_p)
    assert torch.equal(post, before)   # the plane is read, not written


def _given_plane_rows(device, lp, seed, rows=1024):
    """One pair's (D, 1, W) plane for combine's GIVEN kind, built a slab
    of diagonals at a time (a long plane's random draws would not fit at
    once): in the grid a few values a diagonal, each one of four levels
    (ties), and lane 0 and every cell outside the grid 0; x of full
    length, y a little shorter."""
    lx = torch.tensor([lp], dtype=torch.int32, device=device)
    ly = torch.tensor([max(1, lp - lp // 7)], dtype=torch.int32,
                      device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    D, W = 2 * lp + 1, lp + 1
    post = torch.empty((D, 1, W), dtype=torch.float32, device=device)
    levels = torch.tensor([0.125, 0.25, 0.375, 0.5], device=device)
    j = torch.arange(W, device=device)[None, None, :]
    for a in range(0, D, rows):
        n = min(rows, D - a)
        d = torch.arange(a, a + n, device=device)[:, None, None]
        grid = ((j >= 1) & (j <= ly[0]) & (d - j >= 1) & (d - j <= lx[0]))
        level = levels[torch.randint(0, 4, (n, 1, W), generator=g,
                                     device=device)]
        keep = torch.rand((n, 1, W), generator=g, device=device) < 8.0 / W
        post[a:a + n] = torch.where(grid & keep, level, 0.0)
    return post, lx, ly


@pytest.mark.cuda
@pytest.mark.parametrize("lp", _combine_edges())
def test_combine_plan_edges_on_card(cuda_device, lp):
    """combine's cluster instance at the first and the last length of
    each cluster size of each tier (4, 8 and 16 lanes a thread), and the
    one-block instance's last, up to the largest Lp it takes (65,536; a
    34 GB plane): the GIVEN kind over one pair's plane of tied values,
    top-k 16 with match counts and the score alone, against `mwt_skew`
    and `topk_skew`: values, scores and match counts bit-equal, lanes
    equal wherever the value is positive."""
    post, lx, ly = _given_plane_rows(cuda_device, lp, lp * 31 + 7)
    score_p, nb_p = twf.mwt_skew(post, lx, ly, with_matches=True)
    vw, lw = _topk_rows(post, 16, 0.01)
    vals, lanes, score, nb = twk.mwt_topk(post, lx, ly, with_matches=True,
                                          topk=16, cutoff=0.01)
    assert torch.equal(vals, vw)
    assert torch.equal(lanes[vw > 0], lw[vw > 0])
    assert torch.equal(score, score_p)
    assert torch.equal(nb, nb_p)
    del vals, lanes
    assert torch.equal(twk.mwt_topk(post, lx, ly)[0], score_p)
