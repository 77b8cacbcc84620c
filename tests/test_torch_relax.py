"""The port's device relaxation, packed by true lengths and computed on
the blocks i < j only (consistency.relax_packed_rounds, through
`DevicePosteriorTensor.relax_and_extract`), against the JAX package's
dense `relax_dense_rounds` on the same zero-diagonal tensor (CPU on both
sides).

Seeded sparse tensors at Lp = 128 (at most 64 entries a row, so the
top-64 extraction keeps every entry): ragged lengths, three sequences,
and every length equal to Lp; baseMSA's unweighted rounds, QuickProbs'
weighted ones, and weighted with the last round's cutoff at 1e-5.  Each
with the default panels and with one row block a panel.  Tolerance: that
of tests/test_torch_align.py (the sum order of the products differs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from mlprobs_tpu.align import consistency as jcons  # noqa: E402
from mlprobs_tpu_torch.align import consistency as tcons  # noqa: E402
from mlprobs_tpu_torch.align import pairwise as tpw  # noqa: E402
from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS  # noqa: E402
from test_torch_align import _close_modulo_cutoff  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (see tests/test_torch_align.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LP = 128
FAMILIES = {
    "ragged": [37, 128, 64, 90, 101, 45, 77],
    "three": [50, 128, 99],
    "unpadded": [LP] * 5,
}
MODES = {"unweighted": (False, None), "weighted": (True, None),
         "weighted_final": (True, 1e-5)}


def _tensor(lens, seed=3):
    """A zero-diagonal (N, N, LP, LP) tensor with S_ji = S_ij^T, about
    one entry in twelve kept, none under the cutoff."""
    rng = np.random.default_rng(seed)
    n = len(lens)
    S = np.zeros((n, n, LP, LP), np.float32)
    for i in range(n):
        for j in range(i + 1, n):
            p = rng.random((lens[i], lens[j])).astype(np.float32)
            p[(rng.random(p.shape) > 0.08) | (p < 0.01)] = 0.0
            S[i, j, :lens[i], :lens[j]] = p
            S[j, i, :lens[j], :lens[i]] = p.T
    return S


def _weights(mode, n):
    weighted, final = MODES[mode]
    w = np.random.default_rng(7).random(n) + 0.5 if weighted else None
    return w, final


_WANT: dict = {}


def _want(family, mode):
    """The JAX package's dense relaxation, once a family and mode."""
    if (family, mode) not in _WANT:
        lens = FAMILIES[family]
        w, final = _weights(mode, len(lens))
        coeffs = jcons.dense_relax_coeffs(len(lens), w)
        _WANT[family, mode] = np.asarray(jcons.relax_dense_rounds(
            jnp.asarray(_tensor(lens)), *(jnp.asarray(a) for a in coeffs),
            reps=2, final_cutoff=final))
    return _WANT[family, mode]


def _device_tensor(lens):
    n = len(lens)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    return tpw.DevicePosteriorTensor(torch.from_numpy(_tensor(lens)), pairs,
                                     np.zeros((n, n)), list(lens))


@pytest.mark.parametrize("panel_rows", [tcons.PANEL_ROWS, 1])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_packed_relaxation_matches_jax_dense(family, mode, panel_rows,
                                             monkeypatch):
    """The pairs' relaxed CSRs equal the JAX package's dense rounds;
    the keys are the pairs in order; each round that feeds another leaves
    R_ji = R_ij^T exactly; the tensor itself is left as it was."""
    monkeypatch.setattr(tcons, "PANEL_ROWS", panel_rows)
    lens = FAMILIES[family]
    w, final = _weights(mode, len(lens))
    mirrored = []
    real = tcons._relax_round

    def kept(Q, out, *a, mirror, **k):
        flops = real(Q, out, *a, mirror=mirror, **k)
        if mirror:
            mirrored.append(out.clone())
        return flops

    monkeypatch.setattr(tcons, "_relax_round", kept)
    t = _device_tensor(lens)
    S0 = t.S.clone()
    got = t.relax_and_extract(weights=w, reps=2, final_cutoff=final)
    assert list(got) == t.pairs
    assert torch.equal(t.S, S0)
    want = _want(family, mode)
    for (i, j), csr in got.items():
        _close_modulo_cutoff(csr.toarray(), want[i, j, :lens[i], :lens[j]],
                             cutoff=final or tcons.CUTOFF)
    assert len(mirrored) == 1
    R = mirrored[0]
    assert torch.equal(R, R.T)
    assert R.abs().sum() > 0


@pytest.mark.parametrize("panel_rows", [tcons.PANEL_ROWS, 1])
def test_gemm_flops_counts_the_staircase(panel_rows, monkeypatch):
    """`gemm_flops` on the relax span is 2 m n k of each product the
    staircase runs: one panel of the blocks 0..N-2 by the columns right of
    block 0 at the default panel size on this small family, one product a
    block at one row a panel; under half of the dense 2 (N Lp)^3 a
    round."""
    monkeypatch.setattr(tcons, "PANEL_ROWS", panel_rows)
    lens = FAMILIES["ragged"]
    n, reps = len(lens), 2
    sizes = [-(-li // 8) * 8 for li in lens]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    side = int(offs[-1])
    if panel_rows == 1:
        products = [(sizes[i], side - offs[i + 1], side)
                    for i in range(n - 1)]
    else:
        assert side < tcons.PANEL_ROWS
        products = [(offs[n - 1], side - offs[1], side)]
    want = reps * sum(2 * m * k * c for m, k, c in products)
    records: list = []
    with monkeypatch.context() as mp:
        mp.setattr(STATS, "_sinks", [])
        STATS.add_sink(records.append)
        with STATS.span("consistency"):
            _device_tensor(lens).relax_and_extract(reps=reps)
    relax = [r for r in records if r["key"] == "consistency.relax"]
    assert len(relax) == 1
    assert relax[0]["counts"]["gemm_flops"] == want
    assert want < 0.5 * 2 * (n * LP) ** 3 * reps
