"""The port's rules: it imports nothing of JAX or of the JAX package, its
entry points run on the card unless asked for the CPU, and its kernel
wrappers never answer a missing kernel with the plain version."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mlprobs_tpu_torch.align import aligner, pairwise  # noqa: E402
from mlprobs_tpu_torch.ops.kernels import build  # noqa: E402
from mlprobs_tpu_torch.ops.kernels import wavefront_kernel as wk  # noqa: E402
from mlprobs_tpu_torch.pipeline import cli, driver, realign  # noqa: E402
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


ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "mlprobs_tpu_torch"


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "mlprobs_tpu" or name.startswith("mlprobs_tpu."))


def test_importing_the_port_loads_no_jax():
    """Every module of the package, imported in a fresh interpreter,
    brings in neither jax nor any module of the JAX package."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import mlprobs_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,"
        " p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(json.dumps({'imported': names,"
        " 'new': sorted(set(sys.modules) - before)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "mlprobs_tpu_torch.pipeline.cli" in res["imported"]
    assert len(res["imported"]) >= 20
    assert [m for m in res["new"] if _forbidden(m)] == []


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_sources_name_no_jax_module():
    """No source of the package and not chip_smoke.py imports jax or the
    JAX package, even inside a function."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = {str(f.relative_to(ROOT)): sorted(n for n in _imports(f)
                                            if _forbidden(n))
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _family():
    rng = np.random.default_rng(0)
    return [(f"s{k}", "".join("ACDEFGHIKL"[c] for c in rng.integers(0, 10, 30)))
            for k in range(3)]


# a family that classifier 1 sends to the progressive strategy (RCR,
# factor > 0), and one it sends to the non-progressive strategy
PROGRESSIVE = (12, 10, 20, 0.3, 0.1, 4)
NON_PROGRESSIVE = (16, 12, 24, 0.5, 0.1, 2)


@pytest.mark.parametrize("entry", [
    "align_family", "family_viterbi_stats", "device_posterior_tensor",
    "all_pairs_posteriors", "cli", "align_family_quickprobs",
    "run_pipeline", "cli_align", "align_family_np", "cli_base_np",
    "run_pipeline_np",
])
def test_entry_points_need_the_card_unless_asked_for_cpu(no_cuda, entry,
                                                         tmp_path):
    recs = _family()
    seqs = [np.frombuffer(s.encode(), np.uint8) % 20 for _, s in recs]
    seqs = [s.astype(np.int8) for s in seqs]
    calls = {
        "align_family": lambda **kw: aligner.align_family(recs, **kw),
        "family_viterbi_stats":
            lambda **kw: aligner.family_viterbi_stats(seqs, **kw),
        "device_posterior_tensor":
            lambda **kw: pairwise.device_posterior_tensor(seqs, "mix", **kw),
        "all_pairs_posteriors":
            lambda **kw: list(pairwise.all_pairs_posteriors(seqs, "mix",
                                                            **kw)),
        "align_family_quickprobs":
            lambda **kw: aligner.align_family(recs, config="quickprobs",
                                              **kw),
        "run_pipeline":
            lambda **kw: driver.run_pipeline(
                synthetic_family(*PROGRESSIVE), **kw),
        "align_family_np":
            lambda **kw: aligner.align_family(recs, strategy=1, **kw),
        "run_pipeline_np":
            lambda **kw: driver.run_pipeline(
                synthetic_family(*NON_PROGRESSIVE), **kw),
    }
    if entry in ("cli", "cli_align", "cli_base_np"):
        if entry == "cli_align":
            recs = synthetic_family(*PROGRESSIVE)
        args = {"cli": ["base"], "cli_align": ["align"],
                "cli_base_np": ["base", "-p", "1"]}[entry]
        inp = tmp_path / "in.fa"
        inp.write_text("".join(f">{h}\n{s}\n" for h, s in recs))
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(args + [str(inp), str(tmp_path / "out.fa")])
        assert cli.main(args + [str(inp), str(tmp_path / "out.fa"),
                                "--device", "cpu"]) == 0
        assert (tmp_path / "out.fa").read_text().count(">") == len(recs)
        return
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
    assert calls[entry](device="cpu") is not None


def test_np_family_never_takes_the_fallback(monkeypatch):
    """A family that classifier 1 sends to the non-progressive strategy
    gets its NP base MSA and goes on through the pipeline: it does not
    quietly become a whole-family QuickProbs alignment."""
    def no_fallback(*a, **kw):
        raise AssertionError("run_pipeline took the fallback")

    monkeypatch.setattr(driver, "_fallback_align", no_fallback)
    recs = synthetic_family(*NON_PROGRESSIVE)
    msa, rep = driver.run_pipeline(recs, device="cpu")
    assert rep.strategy == 1
    assert not rep.crash_fallback and rep.error == ""
    assert rep.engines["consistency_engine"] in ("host", "device")
    rows = dict(msa.to_records())
    assert all(rows[h].replace("-", "") == s for h, s in recs)


def test_kernel_build_error_in_a_block_realign_propagates(monkeypatch):
    """A block realign keeps its block only for what the reference's
    ladder is for; a kernel that cannot be built leaves run_pipeline."""
    from mlprobs_tpu_torch.models import forests

    real = realign.align_family

    def realigner_without_kernels(records, config="pnp", **kw):
        if config == "quickprobs":
            raise build.KernelBuildError("nvcc not found")
        return real(records, config=config, **kw)

    monkeypatch.setattr(forests, "classify_realign_strategy", lambda *a: 1)
    monkeypatch.setattr(realign, "align_family", realigner_without_kernels)
    recs = synthetic_family(6, 40, 90, 0.2, 0.05, 5)   # four RIR blocks
    with pytest.raises(build.KernelBuildError):
        driver.run_pipeline(recs, device="cpu")


def test_kernel_argument_error_in_a_block_realign_propagates(monkeypatch):
    """A kernel wrapper given a tensor its kernel does not take (here a
    y batch of the wrong shape on a device) inside a block realign: a
    fault of the program, not of the block, so it leaves run_pipeline
    and is not recorded as a block error."""
    from mlprobs_tpu_torch.models import forests

    real = realign.align_family
    meta = torch.device("meta")
    tabs_f, _ = pairwise._wf_tables("partition", None, "cpu")

    def realigner_with_a_bad_call(records, config="pnp", **kw):
        if config == "quickprobs":
            X = torch.empty((2, 128), dtype=torch.int8, device=meta)
            Y = torch.empty((2, 64), dtype=torch.int8, device=meta)
            L = torch.empty((2,), dtype=torch.int32, device=meta)
            wk.sweep(X, Y, L, L, L, L, tabs_f, models=("partition",))
        return real(records, config=config, **kw)

    monkeypatch.setattr(build, "lib", lambda name: None)
    monkeypatch.setattr(forests, "classify_realign_strategy", lambda *a: 1)
    monkeypatch.setattr(realign, "align_family", realigner_with_a_bad_call)
    recs = synthetic_family(6, 40, 90, 0.2, 0.05, 5)   # four RIR blocks
    with pytest.raises(wk.KernelArgumentError, match="shape"):
        driver.run_pipeline(recs, device="cpu")


def test_block_errors_are_recorded(monkeypatch):
    """What the ladder is for (here a device OOM) keeps the block and is
    recorded in the report, never swallowed silently."""
    from mlprobs_tpu_torch.models import forests

    def oom(records, config="pnp", **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")

    monkeypatch.setattr(forests, "classify_realign_strategy", lambda *a: 1)
    monkeypatch.setattr(realign, "align_family", oom)
    recs = synthetic_family(6, 40, 90, 0.2, 0.05, 5)
    msa, rep = driver.run_pipeline(recs, device="cpu")
    assert rep.blocks_realigned == rep.num_realign_blocks == 4
    assert rep.blocks_accepted == 0 and not rep.crash_fallback
    assert len(rep.block_errors) == 4
    assert rep.block_errors[0].startswith("OutOfMemoryError: CUDA out of")
    rows = dict(msa.to_records())
    assert all(rows[h].replace("-", "") == s for h, s in recs)


@pytest.fixture
def no_kernel_library(monkeypatch, tmp_path):
    """No built library and no nvcc: what a machine without the CUDA
    toolkit sees."""
    def missing():
        raise build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", missing)
    build.lib.cache_clear()

    def plain_must_not_run(*a, **kw):
        raise AssertionError("a wrapper fell back to its plain version")

    monkeypatch.setattr(wk, "sweep_reference", plain_must_not_run)
    monkeypatch.setattr(wk, "combine_reference", plain_must_not_run)
    yield
    build.lib.cache_clear()


def test_wrappers_raise_instead_of_falling_back(no_kernel_library):
    """A tensor that is not on the CPU goes to the kernel or raises."""
    meta = torch.device("meta")
    b, lp = 2, 128
    X = torch.empty((b, lp), dtype=torch.int8, device=meta)
    L = torch.empty((b,), dtype=torch.int32, device=meta)
    tabs_f, _ = pairwise._wf_tables("hmm5", None, "cpu")
    launches = (wk.sweep.launches, wk.combine.launches)
    with pytest.raises(build.KernelBuildError):
        wk.sweep(X, X, L, L, L, L, tabs_f, models=("hmm5",))
    with pytest.raises(build.KernelBuildError):
        wk.combine({}, {}, L, L, models=("hmm5",))
    with pytest.raises(build.KernelBuildError):
        wk.posterior(X, X, L, L, tabs_f, tabs_f, models=("hmm5",))
    assert (wk.sweep.launches, wk.combine.launches) == launches
