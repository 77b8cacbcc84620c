"""The port's MLProbs pipeline (`run_pipeline`, `cli align`) and its host
stages against the JAX package, on the CPU on both sides.

Column scores, the three forests and the region finders are host numpy
code and must be equal exactly.  `run_pipeline` must give the JAX
package's final hash and stage decisions on seeded families that take
each realign path: the whole-family realign (RCR, factor <= 0), the
block path (RCR, factor > 0), and realigned blocks accepted or rejected
(classifier 3 forced to RIR on both sides).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu.models import forests as jforests  # noqa: E402
from mlprobs_tpu.ops import colscore as jcol  # noqa: E402
from mlprobs_tpu.pipeline import cli as jcli  # noqa: E402
from mlprobs_tpu.pipeline import driver as jdriver  # noqa: E402
from mlprobs_tpu.pipeline import regions as jreg  # noqa: E402
from mlprobs_tpu_torch.align import aligner as tal  # noqa: E402
from mlprobs_tpu_torch.models import forests as tforests  # noqa: E402
from mlprobs_tpu_torch.ops import colscore as tcol  # noqa: E402
from mlprobs_tpu_torch.pipeline import cli as tcli  # noqa: E402
from mlprobs_tpu_torch.pipeline import driver as tdriver  # noqa: E402
from mlprobs_tpu_torch.pipeline import regions as treg  # noqa: E402
from mlprobs_tpu_torch.utils.synth import synthetic_family  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain PyTorch loops: their tensors are
    small, and parallel test workers with a thread pool each would
    oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (n, lmin, lmax, substitution rate, indel rate, seed)
RCR_WHOLE = (6, 40, 90, 0.2, 0.05, 5)      # classifier 3: RCR, factor <= 0
RCR_BLOCKS = (12, 10, 20, 0.3, 0.1, 4)     # RCR, factor > 0
DECISIONS = ("strategy", "realign_mode", "min_length_class",
             "num_realign_blocks", "whole_family_realign", "crash_fallback",
             "fallback", "factor", "avg_pid", "sd_pid", "error")


@pytest.fixture
def jax_wavefront(monkeypatch):
    """The JAX package on its wavefront engine with the native route off.

    The JAX package reads its engine once and caches it; the variable is
    then unset again, because the port has no "wavefront" engine (its
    CPU path is the default "pallas") and refuses the name."""
    monkeypatch.setenv("MLPROBS_POSTERIOR_ENGINE", "wavefront")
    monkeypatch.setenv("MLPROBS_NATIVE_ROUTE", "0")
    jpw._reset_engine_caches()
    assert jpw._engine() == "wavefront"
    monkeypatch.delenv("MLPROBS_POSTERIOR_ENGINE")
    yield
    monkeypatch.undo()
    jpw._reset_engine_caches()


def _random_rows(n, length, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-1, 21, (n, length)).astype(np.int8)
    rows[:, ::5] = rng.integers(0, 3, (n, len(range(0, length, 5))))
    return rows


def test_column_scores_match_jax():
    rows = [_random_rows(n, 97, seed=n) for n in (1, 2, 7, 30)]
    msa = tal.align_family(synthetic_family(*RCR_WHOLE), device="cpu")
    rows.append(msa.rows)
    for r in rows:
        want = jcol.column_scores(r)
        assert np.array_equal(tcol.column_scores(r), want)
        assert tcol.score_stats(want) == jcol.score_stats(want)


def test_classifiers_match_jax():
    rng = np.random.default_rng(3)
    forests = tforests._load()
    for _ in range(300):
        feats = {}
        for tier in ("branch", "regions", "seq_lens"):
            norm = forests[tier].norm               # rows of (max, min)
            lo, hi = norm[:, 1], norm[:, 0]
            feats[tier] = lo + (hi - lo) * rng.uniform(-0.1, 1.1, len(lo))
        assert (tforests.classify_strategy(*feats["branch"])
                == jforests.classify_strategy(*feats["branch"]))
        assert (tforests.classify_realign_strategy(*feats["regions"])
                == jforests.classify_realign_strategy(*feats["regions"]))
        assert (tforests.classify_region_min_length(*feats["seq_lens"])
                == jforests.classify_region_min_length(*feats["seq_lens"]))


def test_regions_match_jax():
    rng = np.random.default_rng(4)
    cols = [list(rng.normal(1.0, 1.5, 400)) for _ in range(20)]
    msa = tal.align_family(synthetic_family(*RCR_WHOLE), device="cpu")
    cols.append(list(tcol.column_scores(msa.rows)))
    for col in cols:
        for cls in range(4):
            want = jreg.find_unreliable_regions(col, 1.2, 0.0, cls)
            assert treg.find_unreliable_regions(col, 1.2, 0.0, cls) == want
            assert (treg.partition_columns(want, len(col))
                    == [treg.Block(b.start, b.end, b.realign) for b in
                        jreg.partition_columns(want, len(col))])
        for min_len in (0, 5):
            want = jreg.find_reliable_regions(col, 2.0, min_len)
            assert treg.find_reliable_regions(col, 2.0, min_len) == want


@pytest.mark.parametrize("case", ["rcr-whole", "rcr-blocks", "rir-blocks"])
def test_run_pipeline_matches_jax(jax_wavefront, monkeypatch, case):
    fam = RCR_BLOCKS if case == "rcr-blocks" else RCR_WHOLE
    if case == "rir-blocks":
        for mod in (jforests, tforests):
            monkeypatch.setattr(mod, "classify_realign_strategy",
                                lambda *a: 1)
    records = synthetic_family(*fam)
    want_msa, want = jdriver.run_pipeline(records)
    got_msa, got = tdriver.run_pipeline(records, device="cpu")
    assert ({k: getattr(got, k) for k in DECISIONS}
            == {k: getattr(want, k) for k in DECISIONS})
    assert got.final_hash == want.final_hash
    assert got_msa.to_records() == want_msa.to_records()
    assert got.block_errors == []
    if case == "rir-blocks":
        # blocks went through the realigner; some were kept, some not
        assert got.num_realign_blocks == got.blocks_realigned == 4
        assert 0 < got.blocks_accepted < got.blocks_realigned
    elif case == "rcr-whole":
        assert got.whole_family_realign and got.blocks_realigned == 0


def test_cli_align_writes_the_jax_msa(jax_wavefront, tmp_path):
    inp = tmp_path / "in.fa"
    inp.write_text("".join(f">{h}\n{s}\n"
                           for h, s in synthetic_family(*RCR_BLOCKS)))
    assert jcli.main(["align", str(inp), str(tmp_path / "jax.fa")]) == 0
    assert tcli.main(["align", str(inp), str(tmp_path / "port.fa"),
                      "--device", "cpu"]) == 0
    assert ((tmp_path / "port.fa").read_text()
            == (tmp_path / "jax.fa").read_text())
