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
from mlprobs_tpu_torch.pipeline import cli  # noqa: E402

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


@pytest.mark.parametrize("entry", [
    "align_family", "family_viterbi_stats", "device_posterior_tensor",
    "all_pairs_posteriors", "cli",
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
    }
    if entry == "cli":
        inp = tmp_path / "in.fa"
        inp.write_text("".join(f">{h}\n{s}\n" for h, s in recs))
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["base", str(inp), str(tmp_path / "out.fa")])
        assert cli.main(["base", str(inp), str(tmp_path / "out.fa"),
                         "--device", "cpu"]) == 0
        assert (tmp_path / "out.fa").read_text().count(">") == 3
        return
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
    assert calls[entry](device="cpu") is not None


def test_unported_paths_raise():
    recs = _family()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        aligner.align_family(recs, config="quickprobs", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        aligner.align_family(recs, strategy=1, device="cpu")


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
