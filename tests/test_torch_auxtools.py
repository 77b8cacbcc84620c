"""The port's auxiliary tools (pipeline/auxtools.py) and `cli base
--annot/--clustalw/--autosave` against the JAX package's, on the CPU on
both sides.

The four tools are host numpy code and must be equal exactly.  The CLI's
files (the alignment in ClustalW or FASTA, the annotation scores and
every autosaved refinement) must be byte-equal to the JAX CLI's on a
small seeded family.  The JAX side runs its wavefront engine with the
native host route off, as tests/test_torch_align.py runs it.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu.core.msa import MSA as JMSA  # noqa: E402
from mlprobs_tpu.pipeline import auxtools as jaux  # noqa: E402
from mlprobs_tpu.pipeline import cli as jcli  # noqa: E402
from mlprobs_tpu_torch.core.msa import MSA  # noqa: E402
from mlprobs_tpu_torch.pipeline import auxtools as taux  # noqa: E402
from mlprobs_tpu_torch.pipeline import cli as tcli  # noqa: E402
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
    """The JAX package on its wavefront engine with the native route off;
    the engine is read once and cached, and the variable unset again for
    the port, which has no "wavefront" engine."""
    monkeypatch.setenv("MLPROBS_POSTERIOR_ENGINE", "wavefront")
    monkeypatch.setenv("MLPROBS_NATIVE_ROUTE", "0")
    jpw._reset_engine_caches()
    assert jpw._engine() == "wavefront"
    monkeypatch.delenv("MLPROBS_POSTERIOR_ENGINE")
    yield
    monkeypatch.undo()
    jpw._reset_engine_caches()


def _alignment(seed, n=6, length=50):
    """A seeded gapped alignment, rows in a shuffled label order."""
    rng = np.random.default_rng(seed)
    rows = np.where(rng.random((n, length)) < 0.25, -1,
                    rng.integers(0, 20, (n, length))).astype(np.int8)
    rows[:, rng.integers(0, length)] = -1          # one all-gap column
    heads = [f"seq{k} desc {k}" if k % 2 else "" for k in range(n)]
    order = rng.permutation(n)
    return rows[order], [heads[k] for k in order], \
        order.astype(np.int32)


def _posts(rows, labels, seed):
    """Random sparse posteriors keyed (label_i, label_j), i < j, over the
    rows' ungapped residues (one pair left out)."""
    rng = np.random.default_rng(seed)
    lens = {int(lb): int((r >= 0).sum()) for r, lb in zip(rows, labels)}
    posts = {}
    for a in sorted(lens):
        for b in sorted(lens):
            if a < b and (a, b) != (0, 1):
                posts[(a, b)] = sp.random(
                    lens[a], lens[b], density=0.3, format="csr",
                    random_state=int(rng.integers(1 << 31)),
                    dtype=np.float32)
    return posts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auxtools_match_jax(seed):
    rows, heads, labels = _alignment(seed)
    msa = MSA(headers=heads, rows=rows, labels=labels)
    jmsa = JMSA(headers=heads, rows=rows, labels=labels)
    posts = _posts(rows, labels, seed)
    got = taux.annotation_scores(msa.sort_by_label(), posts)
    want = jaux.annotation_scores(jmsa.sort_by_label(), posts)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.max() > 0
    for width in (60, 17):
        assert (taux.write_clustal(msa, width=width)
                == jaux.write_clustal(jmsa, width=width))
    recs = synthetic_family(5, 10, 20, sub=0.3, indel=0.1, seed=seed)
    assert taux.reverse_records(recs) == jaux.reverse_records(recs)
    rng = np.random.default_rng(seed)
    for cols in (rng.normal(1.0, 1.0, 80), np.zeros(0), np.ones(10)):
        for theta, thr in ((0.5, 0.2), (1.0, 0.5), (2.0, 0.9)):
            assert (taux.unreliable_family(cols, theta, thr)
                    == jaux.unreliable_family(cols, theta, thr))


@pytest.mark.parametrize("config", ["pnp", "quickprobs"])
def test_cli_base_files_match_jax(jax_wavefront, tmp_path, config):
    recs = synthetic_family(6, 40, 90, sub=0.2, indel=0.05, seed=5)
    inp = tmp_path / "in.fa"
    inp.write_text("".join(f">{h}\n{s}\n" for h, s in recs))
    flags = ["--config", config, "--clustalw", "--autosave", "1"]
    assert jcli.main(["base", str(inp), str(tmp_path / "jax.aln"),
                      "--annot", str(tmp_path / "jax.annot")] + flags) == 0
    assert tcli.main(["base", str(inp), str(tmp_path / "port.aln"),
                      "--annot", str(tmp_path / "port.annot"),
                      "--device", "cpu"] + flags) == 0
    for a, b in (("jax.aln", "port.aln"), ("jax.annot", "port.annot")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
    saved = sorted(p.name[len("port.aln"):]
                   for p in tmp_path.glob("port.aln_r*"))
    assert saved == sorted(p.name[len("jax.aln"):]
                           for p in tmp_path.glob("jax.aln_r*"))
    for suffix in saved:
        assert ((tmp_path / f"port.aln{suffix}").read_bytes()
                == (tmp_path / f"jax.aln{suffix}").read_bytes())
    # the realigner's refinement autosaves; the base aligner has no hook
    assert bool(saved) == (config == "quickprobs")
    # the annotation: one score in 0-200 per column of the alignment
    scores = [int(v) for v in (tmp_path / "port.annot").read_text().split()]
    aln = (tmp_path / "port.aln").read_text().splitlines()
    width = sum(len(ln.split()[1]) for ln in aln
                if ln.startswith(recs[0][0] + " "))
    assert len(scores) == width and 0 <= min(scores) <= max(scores) <= 200


def test_cli_base_fasta_with_annot_matches_jax(jax_wavefront, tmp_path):
    recs = synthetic_family(5, 30, 60, sub=0.3, indel=0.1, seed=8)
    inp = tmp_path / "in.fa"
    inp.write_text("".join(f">{h}\n{s}\n" for h, s in recs))
    for tag, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        assert main(["base", str(inp), str(tmp_path / f"{tag}.fa"),
                     "--annot", str(tmp_path / f"{tag}.annot")]
                    + extra) == 0
    for ext in ("fa", "annot"):
        assert ((tmp_path / f"port.{ext}").read_bytes()
                == (tmp_path / f"jax.{ext}").read_bytes())
