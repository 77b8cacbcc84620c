"""The port's SP/TC scoring (bench/quality.py) and `cli bench` against
the JAX package's, on the CPU on both sides.

`sp_tc` and `column_identity` are host numpy code and must be equal
exactly.  `cli bench` runs a suite directory of seeded families that this
test writes, with golden MSAs from the JAX package's base aligner; its
per-family lines (bar the seconds) and its summary's scores must be the
JAX CLI's.  The JAX side runs its wavefront engine with the native host
route off, as tests/test_torch_align.py runs it.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlprobs_tpu.align import aligner as jal  # noqa: E402
from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu.bench import quality as jq  # noqa: E402
from mlprobs_tpu.core.msa import MSA as JMSA  # noqa: E402
from mlprobs_tpu.pipeline import cli as jcli  # noqa: E402
from mlprobs_tpu_torch.bench import quality as tq  # noqa: E402
from mlprobs_tpu_torch.core.fasta import write_fasta  # noqa: E402
from mlprobs_tpu_torch.core.msa import MSA  # noqa: E402
from mlprobs_tpu_torch.pipeline import cli as tcli  # noqa: E402
from mlprobs_tpu_torch.pipeline import driver as tdriver  # noqa: E402
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


def _gapped(rng, recs, length):
    """A random alignment of `recs` with `length` columns."""
    out = []
    for h, s in recs:
        cols = np.sort(rng.choice(length, len(s), replace=False))
        row = np.full(length, "-")
        row[cols] = list(s)
        out.append((h, "".join(row)))
    keep = np.array([any(r[c] != "-" for _, r in out)
                     for c in range(length)])
    return [(h, "".join(np.array(list(r))[keep])) for h, r in out]


def _pairs(seed):
    """(test, ref) record lists over one seeded family: random gap
    placements, a reordered test, a test that lacks a sequence and one
    with an extra sequence the reference does not have."""
    rng = np.random.default_rng(seed)
    recs = synthetic_family(7, 15, 30, sub=0.3, indel=0.1, seed=seed)
    ref = _gapped(rng, recs, 40)
    test = _gapped(rng, recs, 45)
    yield test, ref
    yield [test[k] for k in rng.permutation(len(test))], ref
    yield _gapped(rng, recs[1:], 35), ref
    yield test, _gapped(rng, recs[2:], 38)
    yield ref, ref
    yield test[:1], ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sp_tc_and_column_identity_match_jax(seed):
    for test, ref in _pairs(seed):
        t, r = MSA.from_records(test), MSA.from_records(ref)
        jt, jr = JMSA.from_records(test), JMSA.from_records(ref)
        assert tq.sp_tc(t, r) == jq.sp_tc(jt, jr)
        assert tq.column_identity(t, r) == jq.column_identity(jt, jr)
    t = MSA.from_records(ref)
    assert tq.sp_tc(t, t) == (1.0, 1.0)
    assert tq.column_identity(t, t) == 1.0


FAMILIES = {   # name: (n, lmin, lmax, sub, indel, seed)
    "fam_a": (4, 20, 35, 0.3, 0.1, 41),
    "fam_b": (5, 15, 30, 0.4, 0.1, 42),
    "fam_c": (4, 25, 40, 0.2, 0.05, 43),
}


def _suite(tmp_path, jax_golden):
    """tmp/TEST/suite/in/<family> inputs and golden MSAs from the JAX
    base aligner, for all but fam_c, in --golden's directory and in the
    default one (TEST replaced by output4evaluation)."""
    suite = tmp_path / "TEST" / "suite"
    (suite / "in").mkdir(parents=True)
    golden = tmp_path / "golden"
    default = tmp_path / "output4evaluation" / "suite"
    golden.mkdir()
    default.mkdir(parents=True)
    for name, spec in FAMILIES.items():
        recs = synthetic_family(*spec)
        write_fasta(suite / "in" / name, recs, width=0)
        if jax_golden and name != "fam_c":
            msa = jal.align_family(recs, config="pnp")
            for d in (golden, default):
                write_fasta(d / name, msa.to_records(), width=0)
    return suite, golden


def _lines(out):
    """Per-family lines without their seconds, and the summary's scores."""
    rows = out.strip().splitlines()
    fams = [ln.split(":")[0] + ":" + ln.split("s n=", 1)[1]
            for ln in rows[:-1]]
    summary = json.loads(rows[-1])
    summary.pop("mean_sec_per_family")
    return fams, summary


def test_cli_bench_matches_jax(jax_wavefront, tmp_path, capsys):
    suite, golden = _suite(tmp_path, jax_golden=True)
    assert jcli.main(["bench", str(suite), "--golden", str(golden),
                      "--out", str(tmp_path / "jax_out")]) == 0
    want = _lines(capsys.readouterr().out)
    assert tcli.main(["bench", str(suite), "--golden", str(golden),
                      "--out", str(tmp_path / "port_out"),
                      "--family-timeout", "600", "--device", "cpu"]) == 0
    got = _lines(capsys.readouterr().out)
    assert got == want
    fams, summary = got
    assert len(fams) == 3 and summary["families"] == 3
    assert "sp=" in fams[0] and "sp=" not in fams[2]     # no golden fam_c
    assert set(summary) == {"families", "mean_sp_vs_golden",
                            "mean_tc_vs_golden"}
    for name in FAMILIES:
        assert ((tmp_path / "port_out" / name).read_text()
                == (tmp_path / "jax_out" / name).read_text())
    # the default golden directory (TEST -> output4evaluation) and
    # --limit: the first two families, scored as above
    assert tcli.main(["bench", str(suite), "--limit", "2",
                      "--device", "cpu"]) == 0
    fams2, summary2 = _lines(capsys.readouterr().out)
    assert fams2 == fams[:2] and summary2["families"] == 2


def test_cli_bench_resume_and_timeout(tmp_path, capsys, monkeypatch):
    suite, _ = _suite(tmp_path, jax_golden=False)
    out = tmp_path / "out"
    assert tcli.main(["bench", str(suite), "--limit", "1", "--out",
                      str(out), "--device", "cpu"]) == 0
    assert [p.name for p in out.iterdir()] == ["fam_a"]
    capsys.readouterr()
    # --resume skips the family whose output exists
    seen = []
    real = tdriver.run_pipeline

    def spy(records, **kw):
        seen.append(len(records))
        return real(records, **kw)

    monkeypatch.setattr(tdriver, "run_pipeline", spy)
    assert tcli.main(["bench", str(suite), "--out", str(out), "--resume",
                      "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:-1]] == ["fam_b", "fam_c"]
    assert seen == [5, 4]
    assert sorted(p.name for p in out.iterdir()) == sorted(FAMILIES)

    # --family-timeout: a family that outlives it ends the run with 3
    def stuck(records, **kw):
        import time

        time.sleep(30)

    monkeypatch.setattr(tdriver, "run_pipeline", stuck)
    assert tcli.main(["bench", str(suite), "--family-timeout", "1",
                      "--device", "cpu"]) == 3
    assert capsys.readouterr().out.startswith(
        "TIMEOUT: family fam_a exceeded timeout")


def test_cli_bench_pipeline_errors_end_the_run(tmp_path, monkeypatch):
    """A fault of the program is not a scoring error: it leaves the CLI."""
    from mlprobs_tpu_torch.ops.kernels import build

    suite, _ = _suite(tmp_path, jax_golden=False)

    def no_kernels(records, **kw):
        raise build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(tdriver, "run_pipeline", no_kernels)
    with pytest.raises(build.KernelBuildError):
        tcli.main(["bench", str(suite), "--device", "cpu"])
