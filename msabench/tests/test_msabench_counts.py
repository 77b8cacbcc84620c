"""The generator's copy, the work counts, the comparison, and the
module check, on the CPU."""
import subprocess
import sys
from pathlib import Path

import pytest

from msabench import check, generator, work

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("seed", [0, 48, 82, 2**33 + 7])
def test_generator_copy_equals_utils_synth(seed):
    from mlprobs_tpu_torch.utils.synth import synthetic_family

    args = (6, 40, 90, 0.5, 0.1, seed)
    assert generator.synthetic_family(*args) == synthetic_family(*args)


def test_spread_lengths_and_cuts():
    spec = {"n": 4, "lmin": 100, "lmax": 140, "sub": 0.5, "indel": 0.1,
            "cuts": None}
    fams = [generator.family(spec, 2**40 + 3, k) for k in range(3)]
    for f in fams:
        assert sorted(len(s) for _, s in f) == [105, 115, 125, 135]
    assert fams[0] != fams[1]
    assert generator.family(spec, 5, 1) == generator.family(spec, 5, 1)
    spec.update(n=3, lmin=300, lmax=300, cuts=[None, [10, 60], [100, 120]])
    f = generator.family(spec, 9, 0)
    assert [len(s) for _, s in f] == [300, 50, 20]


def test_relax_flops_hand_count():
    # pairs (0,1): z=2: 2*3*4*5; (0,2): z=1: 2*3*5*4; (1,2): z=0:
    # 2*4*5*3 -> 3 * 120 = 360 a round
    assert work.relax_flops([3, 4, 5], 1) == 360.0
    assert work.relax_flops([3, 4, 5], 2) == 720.0
    # four sequences of length 1: each of 6 pairs has 2 z, 2 ops each
    assert work.relax_flops([1, 1, 1, 1], 1) == 24.0


def test_posterior_work_hand_count():
    # mix: 2 sweeps of each model (37, 13, 21), 3 posteriors of 3 ops,
    # the RMS of 3 (7) and the MWT (3): 2*71 + 9 + 7 + 3 = 161 a cell
    ops, nbytes = work.posterior_work("mix", [(2, 3)])
    assert ops == 161 * 6
    assert nbytes == 5 + 4 * 6
    # qp on the qpx route: the partition sweeps and the MWT: 29 a cell;
    # top-k output: 16 (value, lane) pairs a diagonal
    ops, nbytes = work.posterior_work("qp", [(2, 3)], True, dense=False)
    assert ops == 29 * 6
    assert nbytes == 5 + 8 * 16 * 6
    assert work.roofline_seconds(67e12, 0) == 1.0


def test_sp_gap():
    ref = [("a", "AC-D"), ("b", "A-CD")]
    assert check.sp_gap(ref, ref) == 0.0
    # ref aligns a.A~b.A and a.D~b.D; test keeps only A~A
    test = [("a", "ACD-"), ("b", "A-CD")]
    assert check.sp_gap(test, ref) == 0.5
    assert check.degapped_ok([("a", "ACD"), ("b", "ACD")], ref)
    assert not check.degapped_ok([("a", "ACD"), ("b", "ACE")], ref)
    assert not check.degapped_ok([("a", "ACD"), ("b", "ACD")],
                                 [("a", "AC-D"), ("b", "ACD")])


def test_nothing_loads_jax_or_the_jax_package():
    """A CPU run of a small cell and the reference, in a process of its
    own: no loaded module's top-level name is jax, jaxlib, flax or
    mlprobs_tpu, compared whole (mlprobs_tpu_torch is the port)."""
    code = (
        "import json, time, torch; torch.set_num_threads(2)\n"
        "from msabench import harness\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "c = harness.load_json('configs', 'twilight48')\n"
        "c['family'].update(n=4, lmin=30, lmax=40)\n"
        "r = harness.run('base.twilight48', b, 1, 0.1, False,"
        " time.perf_counter(), device='cpu', config=c,"
        " log=lambda *a, **k: None)\n"
        "import msabench.control, msabench.run\n"
        "assert r['correct'], r\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "msabench.run", "--workload",
         "base.twilight48", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(ROOT)}, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and msabench/ a run
    exits with another code than 0 and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "msabench", tmp_path / "msabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "msabench.run", "--workload",
         "base.twilight48", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
