"""The port's non-progressive base aligner (`align_family(strategy=1)`,
`cli base -p 1`, the NP families of `run_pipeline`) against the JAX
package, on the CPU on both sides.

The JAX side runs as its own CPU tests run it: the wavefront engine
(MLPROBS_POSTERIOR_ENGINE=wavefront) with the native host route off
(MLPROBS_NATIVE_ROUTE=0).  `graph_align` and `np_refinement` are host
numpy code: given the JAX package's own posteriors and similarities they
must give its MSA exactly.  The whole NP path must give its
`content_hash` in each posterior mode.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from mlprobs_tpu.align import aligner as jal  # noqa: E402
from mlprobs_tpu.align import graph as jgraph  # noqa: E402
from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu.align import refine_np as jrefine  # noqa: E402
from mlprobs_tpu.core.msa import MSA as JMSA  # noqa: E402
from mlprobs_tpu.pipeline import cli as jcli  # noqa: E402
from mlprobs_tpu.pipeline import driver as jdriver  # noqa: E402
from mlprobs_tpu.utils.crand import GlibcRand as JRand  # noqa: E402
from mlprobs_tpu_torch.align import aligner as tal  # noqa: E402
from mlprobs_tpu_torch.align import graph as tgraph  # noqa: E402
from mlprobs_tpu_torch.align import refine_np as trefine  # noqa: E402
from mlprobs_tpu_torch.core.alphabet import encode  # noqa: E402
from mlprobs_tpu_torch.core.msa import MSA as TMSA  # noqa: E402
from mlprobs_tpu_torch.pipeline import cli as tcli  # noqa: E402
from mlprobs_tpu_torch.pipeline import driver as tdriver  # noqa: E402
from mlprobs_tpu_torch.utils.crand import GlibcRand as TRand  # noqa: E402
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


# (n, lmin, lmax, substitution rate, indel rate, seed)
FAMILIES = {"fam-a": (5, 40, 90, 0.3, 0.1, 1),
            "fam-b": (6, 30, 70, 0.5, 0.1, 2)}
# the family that classifier 1 sends to the non-progressive strategy
NON_PROGRESSIVE = (16, 12, 24, 0.5, 0.1, 2)
DECISIONS = ("strategy", "realign_mode", "min_length_class",
             "num_realign_blocks", "whole_family_realign", "crash_fallback",
             "fallback", "factor", "avg_pid", "sd_pid", "error")


def _three_sequence_case():
    """tests/test_align.py's case: three short sequences and random
    posteriors above 0.5 (seeded here)."""
    rng = np.random.default_rng(7)
    seqs = ["MKVLAT", "MKIATG", "KVLATG"]
    records = [(f"s{i}", s) for i, s in enumerate(seqs)]
    posts = {}
    for i in range(3):
        for j in range(i + 1, 3):
            p = rng.random((len(seqs[i]), len(seqs[j])))
            posts[(i, j)] = sp.csr_matrix(np.where(p > 0.5, p, 0.0))
    sim = rng.random((3, 3))
    return records, posts, (sim + sim.T) / 2


def _jax_np_inputs(monkeypatch, records):
    """The JAX package's NP path on `records`: the relaxed posteriors and
    similarities that reach graph_align and np_refinement, the graph's
    MSA and the final one."""
    seen = {}
    real_graph, real_refine = jgraph.graph_align, jrefine.np_refinement

    def graph(msa, posts, seqs):
        seen["posts"] = posts
        seen["graph"] = real_graph(msa, posts, seqs)
        return seen["graph"]

    def refine(out, posts, dist, rng, base_reps=100):
        seen["sim"] = dist.copy()
        return real_refine(out, posts, dist, rng, base_reps=base_reps)

    monkeypatch.setattr(jgraph, "graph_align", graph)
    monkeypatch.setattr(jrefine, "np_refinement", refine)
    seen["final"] = jal.align_family(records, strategy=1)
    return seen


def _port_msa(jmsa) -> TMSA:
    return TMSA(headers=list(jmsa.headers), rows=jmsa.rows.copy(),
                labels=jmsa.labels.copy())


@pytest.mark.parametrize("case", ["three", "fam-a", "fam-b"])
def test_graph_align_and_np_refinement_match_jax(jax_wavefront, monkeypatch,
                                                 case):
    """On the JAX package's own posteriors and similarities, the port's
    graph and refinement give its MSAs exactly."""
    if case == "three":
        records, posts, sim = _three_sequence_case()
        jmsa = JMSA.from_unaligned(records)
        jseqs = [np.asarray(s[s >= 0]) for s in jmsa.rows]
        want_graph = jgraph.graph_align(jmsa, posts, jseqs)
        want_final = jrefine.np_refinement(want_graph, posts, sim,
                                           JRand(12345))
    else:
        records = synthetic_family(*FAMILIES[case])
        seen = _jax_np_inputs(monkeypatch, records)
        posts, sim = seen["posts"], seen["sim"]
        want_graph, want_final = seen["graph"], seen["final"]
    msa = TMSA.from_unaligned(records)
    seqs = [encode(s) for _, s in records]
    report = {}
    got_graph = tgraph.graph_align(msa, posts, seqs, report=report)
    assert np.array_equal(got_graph.rows, want_graph.rows)
    assert got_graph.headers == list(want_graph.headers)
    assert 0 < report["graph_nodes"] <= report["graph_cells"]
    got_final = trefine.np_refinement(_port_msa(want_graph), posts, sim,
                                      TRand(12345))
    assert np.array_equal(got_final.rows, want_final.rows)
    assert got_final.to_records() == want_final.to_records()


def test_find_similar_matches_jax():
    rng = np.random.default_rng(5)
    for n in (2, 3, 8, 21):
        d = rng.random((n, n))
        d = (d + d.T) / 2
        d[rng.random((n, n)) < 0.1] = 0.5    # ties
        assert trefine.find_similar(d) == jrefine.find_similar(d)


def test_linearise_without_recursion_matches_jax():
    """A chain of 3,000 columns (one node each): the JAX package recurses
    once a node; the port's explicit stack gives the same path."""
    n = 3000
    seqs = [encode("A" * n), encode("A" * n)]
    records = [("a", "A" * n), ("b", "A" * n)]
    posts = {(0, 1): sp.csr_matrix(
        (np.linspace(0.9, 0.5, n), (np.arange(n), np.arange(n))),
        shape=(n, n))}
    want = jgraph.graph_align(JMSA.from_unaligned(records), posts, seqs)
    got = tgraph.graph_align(TMSA.from_unaligned(records), posts, seqs)
    assert got.length == n
    assert np.array_equal(got.rows, want.rows)


def test_cells_sort_as_the_jax_list_sort():
    """The vectorised cell order equals the JAX package's stable sort of
    the cell list, ties included."""
    rng = np.random.default_rng(9)
    posts = {}
    for i, j in ((0, 2), (0, 1), (1, 2)):
        p = np.round(rng.random((7, 9)), 1)      # many equal values
        posts[(i, j)] = sp.csr_matrix(np.where(p > 0.3, p, 0.0))
    want = []
    for (a, b), s in posts.items():
        coo = s.tocoo()
        for i, j, p in zip(coo.row, coo.col, coo.data):
            want.append((a, int(i), b, int(j), float(p)))
    want.sort(key=lambda t: -t[4])
    got = list(zip(*(x.tolist() for x in tgraph.sorted_cells(posts))))
    assert got == want


@pytest.mark.parametrize("pid_class", [0, 2, 3])
def test_align_family_np_matches_jax(jax_wavefront, pid_class):
    """align_family(strategy=1) in mix (pid class 0), local (2) and
    partition (3) mode: the JAX package's MSA."""
    records = synthetic_family(*FAMILIES["fam-a"])
    seqs = [encode(s) for _, s in records]
    st = tal.family_viterbi_stats(seqs, device="cpu")
    jst = jal.FamilyStats(avg_pid=st.avg_pid, sd_pid=st.sd_pid,
                          pid_class=pid_class, variance_bit=st.variance_bit,
                          num_seqs=st.num_seqs)
    st.pid_class = pid_class
    want = jal.align_family(records, stats=jst, strategy=1)
    report = {}
    got = tal.align_family(records, stats=st, strategy=1, report=report,
                           device="cpu")
    assert got.content_hash() == want.content_hash()
    assert report["mode"] == {0: "mix", 2: "local", 3: "partition"}[
        pid_class]
    assert report["consistency_engine"] == "host"


def test_run_pipeline_np_family_matches_jax(jax_wavefront):
    """Classifier 1 sends the family to the NP strategy on both sides;
    the decisions and the final MSA are the JAX package's."""
    records = synthetic_family(*NON_PROGRESSIVE)
    want_msa, want = jdriver.run_pipeline(records)
    got_msa, got = tdriver.run_pipeline(records, device="cpu")
    assert got.strategy == want.strategy == 1
    assert ({k: getattr(got, k) for k in DECISIONS}
            == {k: getattr(want, k) for k in DECISIONS})
    assert got.final_hash == want.final_hash
    assert got.block_errors == []


def test_cli_base_p1_writes_the_jax_msa(jax_wavefront, tmp_path):
    inp = tmp_path / "in.fa"
    inp.write_text("".join(f">{h}\n{s}\n"
                           for h, s in synthetic_family(*FAMILIES["fam-b"])))
    assert jcli.main(["base", str(inp), str(tmp_path / "jax.fa"),
                      "-p", "1"]) == 0
    assert tcli.main(["base", str(inp), str(tmp_path / "port.fa"),
                      "-p", "1", "--device", "cpu"]) == 0
    assert ((tmp_path / "port.fa").read_text()
            == (tmp_path / "jax.fa").read_text())
