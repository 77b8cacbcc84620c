"""The kernel wrappers of the port: their CPU path and, on a card, the
CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on a machine with a GPU and
no JAX:  python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
Tolerances as in tests/test_torch_wavefront.py: sweep planes 1e-5
relative to each row's max after aligning both to one scale, log2 totals
2e-4, posteriors 2e-4, MWT score rtol 1e-4 / atol 1e-3, match counts
exact, top-k values 1e-7 with lanes equal wherever the value is
positive.
"""
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
    (a warp's lanes, 4, 8 and 16 lanes a thread, a ring too deep for
    shared memory at Lp = 4,100), x or y of full length so the MWT
    terminal sits on the last lane and the last diagonal: dense plane
    within 2e-4 and exact zeros outside the grid, score rtol 1e-4 /
    atol 1e-3, match counts exact, top-k 1 and 16 values within 1e-7 and
    lanes equal wherever the value is positive."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("mode,lp", [
    ("mix", 8192), ("mix", 12288), ("mix", 16384),
    ("qp", 8320), ("hmm5", 8320), ("local", 8320), ("partition", 8320),
])
def test_kernels_past_8192_lanes_on_card(cuda_device, mode, lp):
    """Both kernels at B = 1, x of full length and y shorter, at the
    short instances' last length and past it (Lp = 8,192: the sweep's
    cluster of 8 blocks at 4 lanes a thread, combine's 32 lanes a
    thread; Lp = 8,320, 12,288 and 16,384: the sweep at 32 lanes a
    thread, combine's DP in 3, 3 and 4 tiles): the sweep as in
    test_sweep_cluster_edges_on_card; combine as in
    test_combine_lane_edges_on_card."""
    models = MODEL_SETS[mode]
    X, Y, lx, ly = (t[:1].contiguous() for t in _edge_batch(
        cuda_device, lp, 2, seed=lp + len(models)))
    tf, tr = tpw._wf_tables(mode, 0.17, cuda_device)
    fk, rk = _sweeps(twk.sweep, X, Y, lx, ly, tf, tr, models)
    fp, rp = _sweeps(twk.sweep_reference, X, Y, lx, ly, tf, tr, models)
    _sweeps_vs_plain(fk, rk, fp, rp, models)
    del fp, rp
    _combine_vs_plain(fk, rk, lx, ly, models)
