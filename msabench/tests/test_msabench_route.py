"""The reference route `graph_replay` (routes/graph_replay.py) against
msaref's own loops: every value equal to the last bit, on the CPU (the
route's steps called) and on the card (captured and replayed, marker
`cuda`); `check.reference` runs the route, and msaref's own loops with
`plain=True`."""
import numpy as np
import pytest
import torch

from msabench import check, generator, harness
from msabench.msaref.align import pairwise as rp
from msabench.msaref.core.alphabet import encode
from msabench.msaref.models import params as mp
from msabench.msaref.ops import plain
from msabench.msaref.ops import wavefront as wf
from msabench.routes import graph_replay

# family shapes at a size a test run holds.  ONE and TWO: one long
# member and two cut from it; ONE: every pair in one 128-residue bucket;
# TWO: the pairs with the long member in one bucket, the short pair in
# another.  TWILIGHT: twilight48's identity, five members of 40-70.
SHAPES = {
    "one": {"n": 3, "lmin": 120, "lmax": 120, "sub": 0.3, "indel": 0.05,
            "cuts": [None, [10, 110], [30, 100]]},
    "two": {"n": 3, "lmin": 300, "lmax": 300, "sub": 0.3, "indel": 0.05,
            "cuts": [None, [20, 90], [150, 200]]},
    "twilight": {"n": 5, "lmin": 40, "lmax": 70, "sub": 0.5, "indel": 0.1,
                 "cuts": None},
}
MODELS = ("hmm5", "partition", "local")


def _batches(spec, device, force):
    seqs = [encode(s) for _, s in generator.family(spec, 2**33 + 17, 0)]
    n = len(seqs)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    lp = rp._bucket_len(max(len(s) for s in seqs)) if force else None
    return list(rp.iter_pair_batches(seqs, pairs, torch.device(device),
                                     force_lp=lp))


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(u, v) for u, v in zip(a, b))
    return torch.equal(a, b)


def _loops_equal(shape, device):
    tabs_f, tabs_r = rp._wf_tables("mix", None, torch.device(device))
    pl, vinit, bl = rp.viterbi_tables(np.asarray(mp.blosum62()), device)
    buckets = set()
    for force in (True, False):
        for _, X, Y, LX, LY in _batches(SHAPES[shape], device, force):
            buckets.add(X.shape[1])
            want = plain.sweeps(X, Y, LX, LY, tabs_f, tabs_r, MODELS)
            with graph_replay.install():
                got = plain.sweeps(X, Y, LX, LY, tabs_f, tabs_r, MODELS)
            assert _equal(got, want)       # planes, scales, totals
            fwd, rev = want
            for kw in ({}, {"with_matches": True, "topk": 16}):
                want = plain.combine(fwd, rev, LX, LY, MODELS, **kw)
                with graph_replay.install():
                    got = plain.combine(fwd, rev, LX, LY, MODELS, **kw)
                assert _equal(got, want)   # MWT, top-k lists
            want = plain.viterbi_stats(X, Y, LX, LY, pl, vinit, bl)
            with graph_replay.install():
                got = plain.viterbi_stats(X, Y, LX, LY, pl, vinit, bl)
            assert _equal(got, want)
    return buckets


def _reference_equal(shape, device):
    traffic = harness.load_json("traffic", "base")
    harness.apply_env(traffic)
    recs = generator.family(SHAPES[shape], 2**33 + 17, 0)
    want = check.reference(traffic, recs, device, relax_control=True,
                           plain=True)
    got = check.reference(traffic, recs, device, relax_control=True)
    assert got.records == want.records
    for a, b in ((got.relax, want.relax), (got.relax_f32, want.relax_f32)):
        assert len(a) == len(b) == 1
        for key in b[0]:
            u, v = a[0][key], b[0][key]
            if hasattr(v, "indptr"):
                u, v = (u.indptr, u.indices, u.data), (v.indptr, v.indices,
                                                      v.data)
            assert all(np.array_equal(x, y) for x, y in zip(u, v)), key


@pytest.mark.parametrize("shape, buckets", [("one", 1), ("two", 2),
                                            ("twilight", 1)])
def test_route_loops_equal_msaref(shape, buckets):
    """The sweeps' planes, scales and totals, combine's MWT and top-k
    lists and the Viterbi feature pass, batch by batch, bit for bit;
    the features' own buckets are one or two."""
    torch.set_num_threads(2)
    got = _loops_equal(shape, "cpu")
    assert len(got) == buckets


@pytest.mark.parametrize("shape", ["one", "two", "twilight"])
def test_route_reference_equals_msaref(shape):
    """The whole reference through the route: the MSA, the float64 and
    the float32 relaxations' entries, bit for bit."""
    torch.set_num_threads(2)
    _reference_equal(shape, "cpu")


@pytest.mark.parametrize("plain", [False, True])
def test_reference_runs_the_route_unless_plain(plain, monkeypatch):
    """check.reference runs msaref with the route's loops in place of
    its own, and msaref's own loops with plain=True."""
    ran = []
    for name, fn in graph_replay.REPLACED.items():
        def spy(*a, _fn=fn, **k):
            ran.append("route")
            return _fn(*a, **k)
        monkeypatch.setitem(graph_replay.REPLACED, name, spy)
    orig = wf.wavefront_forward

    def own(*a, **k):
        ran.append("msaref")
        return orig(*a, **k)
    monkeypatch.setattr(wf, "wavefront_forward", own)
    torch.set_num_threads(2)
    ref = check.reference(harness.load_json("traffic", "base"),
                          generator.family(SHAPES["twilight"], 3, 0), "cpu",
                          plain=plain)
    assert ref.records
    assert set(ran) == ({"msaref"} if plain else {"route"})
    assert wf.wavefront_forward is own     # restored after the run


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["one", "two", "twilight"])
def test_route_equals_msaref_on_the_card(card, shape):
    """The same, with the loops captured as CUDA graphs and replayed."""
    _loops_equal(shape, card)
    _reference_equal(shape, card)
