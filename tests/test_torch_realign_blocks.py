"""The block realigner (`pipeline/realign.py`) under QuickProbs'
large-family settings, on the CPU: the port against the JAX package and
the benchmark's plain reference (msabench/msaref), and the spans the
port keeps of each block.

The family shape is test_torch_pipeline.py's RCR block family (N = 12,
10-20 residues).  The large-family threshold is lowered below 12 in the
port, in msaref and in the JAX package alike, so that every block's
QuickProbs call takes one consistency round re-sparsified at the final
cutoff, as every block call of a family past 50 sequences does.  Seed 7
takes RCR and keeps its realigned block; seed 30 takes RIR and rejects
it.
"""
import pytest

torch = pytest.importorskip("torch")

from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu.core.config import DEFAULT as JCFG  # noqa: E402
from mlprobs_tpu.pipeline import driver as jdriver  # noqa: E402
from mlprobs_tpu.pipeline import realign as jrealign  # noqa: E402
from mlprobs_tpu_torch.core.config import DEFAULT as TCFG  # noqa: E402
from mlprobs_tpu_torch.pipeline import driver as tdriver  # noqa: E402
from mlprobs_tpu_torch.pipeline import realign as trealign  # noqa: E402
from mlprobs_tpu_torch.utils.stats import GLOBAL as STATS  # noqa: E402
from mlprobs_tpu_torch.utils.synth import synthetic_family  # noqa: E402
from msabench.msaref.core.config import DEFAULT as RCFG  # noqa: E402
from msabench.msaref.pipeline import driver as rdriver  # noqa: E402

SHAPE = (12, 10, 20, 0.3, 0.1)      # test_torch_pipeline.RCR_BLOCKS
SEEDS = {7: (0, True), 30: (1, False)}   # seed: (classifier 3, accepted)
LARGE_BELOW = 2                     # every block of 3 or more rows
REPORT = ("blocks_realigned", "blocks_accepted", "num_realign_blocks",
          "realign_mode", "whole_family_realign", "factor", "error")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain PyTorch loops (see
    test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """{seed: (JAX (msa, report), port (msa, report, span records,
    widths of the blocks given to realign_block), msaref msa)} of each
    seed's family, every block call under the large-family settings;
    computed once a seed."""
    got: dict = {}

    def run(seed):
        if seed in got:
            return got[seed]
        records = synthetic_family(*SHAPE, seed)
        with pytest.MonkeyPatch.context() as mp:
            for cfg in (JCFG, TCFG, RCFG):
                mp.setattr(cfg.realigner, "large_family_threshold",
                           LARGE_BELOW)
            # the JAX package on its wavefront engine, native route off
            # (test_torch_pipeline.jax_wavefront)
            mp.setenv("MLPROBS_POSTERIOR_ENGINE", "wavefront")
            mp.setenv("MLPROBS_NATIVE_ROUTE", "0")
            jpw._reset_engine_caches()
            # the JAX package's report has no block counts: its acceptance
            # test's two scores a block (the base block's, the realigned
            # one's) give them
            scores: list = []
            score = jrealign.avg_col_score
            mp.setattr(jrealign, "avg_col_score",
                       lambda rows: scores.append(score(rows)) or scores[-1])
            jmsa, jrep = jdriver.run_pipeline(records)
            pairs = list(zip(scores[::2], scores[1::2]))
            jrep.blocks_realigned = len(pairs)
            jrep.blocks_accepted = sum(old <= new for old, new in pairs)
            mp.delenv("MLPROBS_POSTERIOR_ENGINE")
            spans: list = []
            widths: list = []
            realign_block = trealign.realign_block

            def recorded(block_msa, *a, **k):
                widths.append(block_msa.length)
                return realign_block(block_msa, *a, **k)
            mp.setattr(trealign, "realign_block", recorded)
            mp.setattr(STATS, "_sinks", [spans.append])
            tmsa, trep = tdriver.run_pipeline(records, device="cpu")
            mp.setattr(STATS, "_sinks", [])
            rmsa, _ = rdriver.run_pipeline(records, device="cpu")
        jpw._reset_engine_caches()
        got[seed] = ((jmsa, jrep), (tmsa, trep, spans, widths), rmsa)
        return got[seed]
    return run


@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_block_path_matches_jax(runs, seed):
    (jmsa, jrep), (tmsa, trep, *_), _ = runs(seed)
    mode, accepted = SEEDS[seed]
    assert trep.realign_mode == mode and trep.factor > 0
    assert not trep.whole_family_realign and not trep.crash_fallback
    assert trep.blocks_realigned >= 1
    assert (trep.blocks_accepted == trep.blocks_realigned) == accepted
    assert ({k: getattr(trep, k) for k in REPORT}
            == {k: getattr(jrep, k) for k in REPORT})
    assert trep.block_errors == []
    assert tmsa.to_records() == jmsa.to_records()


@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_block_path_matches_the_plain_reference(runs, seed):
    (jmsa, _), (tmsa, *_), rmsa = runs(seed)
    assert rmsa.to_records() == tmsa.to_records() == jmsa.to_records()


@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_block_spans_count_the_report(runs, seed):
    _, (_, trep, spans, widths), _ = runs(seed)
    by_id = {r["id"]: r for r in spans}
    blocks = [r for r in spans if r["key"] == "realign.block"]
    assert len(blocks) == trep.blocks_realigned
    for b in blocks:
        assert by_id[b["parent"]]["key"] == "stage.realign"
        # one device relaxation a block, of one round: the large-family
        # settings on the dense tensor's route
        assert b["counts"]["blocks"] == 1 and b["counts"]["rounds"] == 1
        kids = {r["key"] for r in spans if r["parent"] == b["id"]}
        assert kids == {"align_family"}
    assert sum(b["counts"].get("blocks_accepted", 0)
               for b in blocks) == trep.blocks_accepted
    # each block's width in the base MSA (every realign block of these
    # families has two or more rows with residues, so each goes through
    # the realigner)
    assert trep.num_realign_blocks == trep.blocks_realigned
    assert [b["counts"]["block_columns"] for b in blocks] == widths
    stage = next(r for r in spans if r["key"] == "stage.realign")
    combine = [r for r in spans if r["key"] == "realign.combine"]
    assert len(combine) == 1 and combine[0]["parent"] == stage["id"]
