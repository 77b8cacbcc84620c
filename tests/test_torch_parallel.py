"""The port's pairs mesh (mlprobs_tpu_torch/parallel/) and the sharded
routes of align/pairwise.py against the JAX package's, on the CPU.

The port's mesh is a list of devices driven by one process; the CPU
tests run a mesh of eight "cpu" entries, as the JAX package's tests run
its eight virtual CPU devices (tests/conftest.py).  Tolerances: the
sharded posterior step atol 2e-4 (planes) and 2e-3 (scores), those of
tests/test_parallel.py; the sharded relaxation atol 1e-6 against the
JAX package's single-device rounds; with and without a mesh, the port's
posteriors bit for bit and its relaxed CSRs to 1e-6; MSAs by content
hash.  The JAX side runs on its wavefront engine with the native host
route off, as tests/test_torch_align.py runs it.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mlprobs_tpu.align import aligner as jal  # noqa: E402
from mlprobs_tpu.align import consistency as jcons  # noqa: E402
from mlprobs_tpu.align import pairwise as jpw  # noqa: E402
from mlprobs_tpu.parallel import mesh as jmesh  # noqa: E402
from mlprobs_tpu.parallel import sharded as jsh  # noqa: E402
from mlprobs_tpu_torch.align import aligner as tal  # noqa: E402
from mlprobs_tpu_torch.align import pairwise as tpw  # noqa: E402
from mlprobs_tpu_torch.parallel import distributed as tdist  # noqa: E402
from mlprobs_tpu_torch.parallel import sharded as tsh  # noqa: E402
from mlprobs_tpu_torch.parallel.mesh import pairs_mesh  # noqa: E402
from mlprobs_tpu_torch.utils.synth import synthetic_family  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LEAVE = 0.170705
MESH8 = pairs_mesh(["cpu"] * 8)


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
    """The JAX package on its wavefront engine with the native route off
    and no mesh; the engine variable is unset again for the port, which
    has no "wavefront" engine."""
    monkeypatch.setenv("MLPROBS_POSTERIOR_ENGINE", "wavefront")
    monkeypatch.setenv("MLPROBS_NATIVE_ROUTE", "0")
    monkeypatch.setenv("MLPROBS_MULTICHIP", "0")
    jpw._reset_engine_caches()
    assert jpw._engine() == "wavefront" and jpw._mesh() is None
    monkeypatch.delenv("MLPROBS_POSTERIOR_ENGINE")
    monkeypatch.delenv("MLPROBS_MULTICHIP")
    tpw._reset_engine_caches()
    yield
    monkeypatch.undo()
    jpw._reset_engine_caches()
    tpw._reset_engine_caches()


def _use_mesh(monkeypatch, mesh):
    monkeypatch.setattr(tpw, "_mesh", lambda device="cuda": mesh)


def test_mesh_from_multichip_setting(monkeypatch):
    """MLPROBS_MULTICHIP: "1" shards over every visible card when there
    are two or more and the run is on the card; unset, "auto" and "0"
    shard nowhere; the CPU and one card are never sharded."""
    from mlprobs_tpu_torch.parallel.mesh import PairsMesh

    for cards in (1, 4):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        for setting in (None, "auto", "0", "1"):
            if setting is None:
                monkeypatch.delenv("MLPROBS_MULTICHIP", raising=False)
            else:
                monkeypatch.setenv("MLPROBS_MULTICHIP", setting)
            assert tpw._mesh("cpu") is None
            mesh = tpw._mesh("cuda")
            if setting == "1" and cards == 4:
                assert mesh == PairsMesh(tuple(
                    torch.device("cuda", k) for k in range(4)))
            else:
                assert mesh is None, (cards, setting)


def test_batch_splits_evenly_over_any_mesh(monkeypatch):
    """The JAX package rounds a mesh batch to max(bs, mesh size): 256 pairs
    over 3 devices.  The port takes each mesh entry's batch from its
    device's budget, shared among the entries that name that device, times
    the mesh size: a batch that splits evenly, each card holding its own
    batch's planes."""
    from mlprobs_tpu_torch.parallel.mesh import PairsMesh

    jmesh3 = jmesh.pairs_mesh(3)
    monkeypatch.setattr(jpw, "_mesh", lambda: jmesh3)
    assert jpw._wf_batch_size(128) == 256 and 256 % 3
    mesh3 = pairs_mesh(["cpu"] * 3)
    cpu = torch.device("cpu")
    assert tpw._wf_batch_size(128, cpu) == 256
    assert tpw._wf_batch_size(128, cpu, mesh3) == 3 * 256
    cards3 = PairsMesh(tuple(torch.device("cuda", k) for k in range(3)))
    monkeypatch.setattr(tpw, "engine_budgets",
                        lambda *a: (80 * 128 * 128 * 5, 1 << 40))
    assert tpw._wf_batch_size(128, cpu) == 4
    assert tpw._wf_batch_size(128, cpu, mesh3) == 3
    assert tpw._wf_batch_size(128, cpu, MESH8) == 8
    assert tpw._wf_batch_size(128, cpu, cards3) == 12
    two_on_one = PairsMesh(cards3.devices[:1] * 2 + cards3.devices[1:2])
    assert tpw._wf_batch_size(128, cpu, two_on_one) == 6


def test_sharded_posterior_step_matches_jax():
    """The inputs of tests/test_parallel.py: B = 16 over 8 devices."""
    rng = np.random.default_rng(0)
    b, lp = 16, 128
    X = rng.integers(0, 20, (b, lp)).astype(np.int8)
    Y = rng.integers(0, 20, (b, lp)).astype(np.int8)
    LX = np.full((b,), 40, np.int32)
    LY = np.full((b,), 35, np.int32)
    jm = jmesh.pairs_mesh(8)
    shard = jmesh.pair_sharding(jm)
    want_p, want_s = jsh.make_sharded_posterior_step(jm)(
        *(jax.device_put(jnp.asarray(a), shard) for a in (X, Y, LX, LY)))
    got_p, got_s = tsh.make_sharded_posterior_step(MESH8)(
        *map(torch.from_numpy, (X, Y, LX, LY)))
    assert got_p.shape == (b, lp, lp) and got_s.shape == (b,)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=2e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=2e-3)


def _random_posterior_tensor(rng, n, lp):
    """Zero-diagonal symmetric-consistent sparse posterior tensor: the
    generator of tests/test_parallel.py with each plane's rows scaled to
    sum to at most 1, as a posterior's do, so that relaxed values stay
    at posterior scale, where atol 1e-6 is ~8 f32 steps (the JAX package
    and PyTorch contract in other orders)."""
    s = rng.random((n, n, lp, lp)) ** 6
    s /= np.maximum(1.0, s.sum(axis=3, keepdims=True))
    s = s.astype(np.float32)
    s[s < 0.01] = 0.0
    iu = np.triu_indices(n, 1)
    s[iu[1], iu[0]] = np.swapaxes(s[iu[0], iu[1]], 1, 2)
    s[np.arange(n), np.arange(n)] = 0.0
    return s


def _coeffs(n, weighted):
    if not weighted:
        return jcons.dense_relax_coeffs(n)
    w = np.random.default_rng(7).random(n) + 0.5
    return jcons.dense_relax_coeffs(n, w, selfweight=3.0, selectivity=200.0)


@pytest.mark.parametrize("weighted,final_cutoff", [
    (False, None), (True, None), (True, 1e-5)],
    ids=["pnp", "weighted", "weighted-final-cutoff"])
def test_sharded_consistency_matches_jax_rounds(weighted, final_cutoff):
    """Each round of `make_sharded_consistency` on the 8-device mesh, and
    the production route `_relax_sharded` on a mesh of 3 (N = 8 padded
    to 9), against the JAX package's single-device `relax_dense_rounds`."""
    rng = np.random.default_rng(1 + weighted)
    n, lp, reps = 8, 64, 2
    s = _random_posterior_tensor(rng, n, lp)
    sc, zs, w = _coeffs(n, weighted)
    want = np.asarray(jcons.relax_dense_rounds(
        jnp.asarray(s), jnp.asarray(sc), jnp.asarray(zs), jnp.asarray(w),
        reps=reps, final_cutoff=final_cutoff))
    relax = tsh.make_sharded_consistency(MESH8, n)
    blocks = tsh.split_rows(torch.from_numpy(s), MESH8)
    for it in range(reps):
        c = final_cutoff if final_cutoff and it == reps - 1 else 0.01
        blocks = relax(blocks, *map(torch.from_numpy, (sc, zs, w)),
                       cutoff=c)
    got = tsh.gather_rows(blocks, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if final_cutoff:
        assert ((want > 0) & (want < 0.01)).any()
    three = tpw._relax_sharded(torch.from_numpy(s), sc, zs, w, reps,
                               pairs_mesh(["cpu"] * 3),
                               final_cutoff=final_cutoff).numpy()
    np.testing.assert_allclose(three, want, rtol=0, atol=1e-6)


def test_jax_sharded_relaxation_ignores_final_cutoff():
    """The fault on the JAX side: its `_relax_sharded` takes
    `final_cutoff` and re-thresholds every round at 0.01, so with the
    realigner's accept-all final cutoff it drops the last round's
    entries between 1e-5 and 0.01 that its single-device route keeps.
    The port's sharded route keeps them."""
    rng = np.random.default_rng(4)
    n, lp = 8, 64
    s = _random_posterior_tensor(rng, n, lp)
    sc, zs, w = _coeffs(n, True)
    single = np.asarray(jcons.relax_dense_rounds(
        jnp.asarray(s), jnp.asarray(sc), jnp.asarray(zs), jnp.asarray(w),
        reps=2, final_cutoff=1e-5))
    jax_sharded = np.asarray(jpw._relax_sharded(
        jnp.asarray(s), sc, zs, w, 2, jmesh.pairs_mesh(8),
        final_cutoff=1e-5))
    low = (single > 0) & (single < 0.01)
    assert low.sum() > 100
    assert (jax_sharded[low] == 0).all()
    port = tpw._relax_sharded(torch.from_numpy(s), sc, zs, w, 2, MESH8,
                              final_cutoff=1e-5).numpy()
    np.testing.assert_allclose(port, single, rtol=0, atol=1e-6)


def _seqs(n=5, lo=40, hi=90, seed=21):
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, 20, hi)
    out = []
    for _ in range(n):
        s = np.where(rng.random(hi) < 0.5, rng.integers(0, 20, hi), anc)
        out.append(s[: int(rng.integers(lo, hi))].astype(np.int8))
    return out


@pytest.mark.parametrize("mode", ["mix", "qp"])
def test_mesh_posteriors_and_relaxation_equal_unsharded(monkeypatch, mode):
    """The production routes with the pairs mesh against the same calls
    without it: sparse posteriors, scores and match counts bit for bit,
    the dense tensor bit for bit, the relaxed CSRs to 1e-6."""
    seqs = _seqs()

    def run():
        posts = {k: (c, sc, nb) for k, c, sc, nb in tpw.all_pairs_posteriors(
            seqs, mode, LEAVE, with_matches=True, device="cpu")}
        t = tpw.device_posterior_tensor(seqs, mode, LEAVE, device="cpu")
        kw = ({"weights": np.linspace(0.5, 1.5, len(seqs)),
               "final_cutoff": 1e-5} if mode == "qp" else {})
        return posts, t, t.relax_and_extract(reps=2, **kw)

    p0, t0, r0 = run()
    _use_mesh(monkeypatch, MESH8)
    p1, t1, r1 = run()
    assert p0.keys() == p1.keys()
    for k in p0:
        assert (p0[k][0] != p1[k][0]).nnz == 0
        assert p0[k][1:] == p1[k][1:]
    assert torch.equal(t0.S, t1.S) and np.array_equal(t0.dist, t1.dist)
    assert r0.keys() == r1.keys()
    for k in r0:
        a, b = r0[k].toarray(), r1[k].toarray()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_mesh_feature_pass_equals_unsharded(monkeypatch):
    seqs = _seqs(seed=22)
    want = tal.family_viterbi_stats(seqs, with_features=True, device="cpu")
    _use_mesh(monkeypatch, pairs_mesh(["cpu"] * 3))
    got = tal.family_viterbi_stats(seqs, with_features=True, device="cpu")
    assert got == want


_JAX_HASH: dict = {}


@pytest.mark.parametrize("size", [8, 3])
def test_align_family_on_a_mesh_matches_jax(jax_wavefront, monkeypatch,
                                            size):
    """A seeded twilight-zone family (mix mode, device consistency) on a
    mesh of 8 and of 3 (pairs and rows padded): the JAX package's MSA."""
    records = synthetic_family(5, 50, 110, 0.6, 0.1, 1)
    if "pnp" not in _JAX_HASH:
        _JAX_HASH["pnp"] = jal.align_family(records,
                                            config="pnp").content_hash()
    _use_mesh(monkeypatch, pairs_mesh(["cpu"] * size))
    report: dict = {}
    got = tal.align_family(records, config="pnp", report=report,
                           device="cpu")
    assert report["consistency_engine"] == "device"
    assert got.content_hash() == _JAX_HASH["pnp"]


_DIST_CHILD = """
import json, sys
import torch
import torch.distributed as dist
from mlprobs_tpu_torch.parallel.distributed import init_distributed, my_families
torch.set_num_threads(1)
pid, n = init_distributed(device="cpu")
t = torch.tensor([float(pid + 1)])
dist.all_reduce(t)
fams = my_families([f"f{k}" for k in range(7)][::-1], pid, n)
dist.destroy_process_group()
print(json.dumps({"pid": pid, "n": n, "sum": float(t), "fams": fams}))
"""


def test_init_distributed_in_two_gloo_processes():
    """Two processes join through MLPROBS_COORDINATOR, all-reduce, and
    stripe seven families between them; with no coordinator the call is
    single-process and starts no group."""
    assert tdist.init_distributed(device="cpu") == (0, 1)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, MLPROBS_COORDINATOR=f"localhost:{port}",
                   MLPROBS_NUM_PROCESSES="2", MLPROBS_PROCESS_ID=str(rank),
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _DIST_CHILD], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    import json

    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert [o["pid"] for o in outs] == [0, 1]
    assert all(o["n"] == 2 and o["sum"] == 3.0 for o in outs)
    assert outs[0]["fams"] == ["f0", "f2", "f4", "f6"]
    assert outs[1]["fams"] == ["f1", "f3", "f5"]
