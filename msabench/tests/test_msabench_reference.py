"""The plain reference (msabench/msaref) against the port on the CPU,
where the port runs its kernels' plain versions: its NumPy merge helpers
equal the port's C++ ones bit for bit, and both entries give the port's
MSA at a small size."""
import numpy as np
import pytest
import torch

from msabench import generator, harness
from msabench.msaref.utils import host as ref_host


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (5, 7), (40, 13),
                                   (13, 40), (300, 120), (120, 300)])
@pytest.mark.parametrize("levels", [0, 1, 4])
def test_mwt_fill_and_traceback_equal_the_cpp(shape, levels):
    from mlprobs_tpu_torch.utils import host

    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    p = rng.random(shape).astype(np.float32)
    if levels:    # ties
        p = (np.round(p * levels) / levels).astype(np.float32)
    d1, s1 = ref_host.mwt_fill(p)
    d2, s2 = host.mwt_fill(p)
    assert s1 == s2 and np.array_equal(d1, d2)
    assert np.array_equal(ref_host.mwt_traceback(d1, *shape),
                          host.mwt_traceback(d2, *shape))


@pytest.mark.parametrize("cutoff", [0.0, 0.01])
def test_profile_posterior_equals_the_cpp(cutoff):
    from mlprobs_tpu_torch.utils import host

    rng = np.random.default_rng(7)
    l1, l2, n1, n2 = 30, 25, 3, 2
    maps1 = [np.sort(rng.choice(l1, 20, replace=False)).astype(np.int32)
             for _ in range(n1)]
    maps2 = [np.sort(rng.choice(l2, 18, replace=False)).astype(np.int32)
             for _ in range(n2)]
    rs, cs, vs, starts, lens, a_idx, b_idx = [], [], [], [], [], [], []
    off = 0
    for a in range(n1):
        for b in range(n2):
            n = 40
            r = np.sort(rng.integers(0, 20, n)).astype(np.int32)
            c = rng.integers(0, 18, n).astype(np.int32)
            rs.append(r), cs.append(c)
            vs.append(rng.random(n).astype(np.float32))
            starts.append(off), lens.append(n), a_idx.append(a)
            b_idx.append(b)
            off += n
    args = (l1, l2, np.array(starts, np.int64), np.array(lens, np.int64),
            np.array(a_idx, np.int32), np.array(b_idx, np.int32),
            rng.random(len(starts)), np.concatenate(rs), np.concatenate(cs),
            np.concatenate(vs), np.concatenate(maps1),
            np.array([0, 20, 40, 60], np.int64), np.concatenate(maps2),
            np.array([0, 18, 36], np.int64), cutoff)
    assert np.array_equal(ref_host.profile_posterior(*args),
                          host.profile_posterior(*args))


@pytest.mark.parametrize("traffic", ["base", "align"])
def test_reference_msa_equals_the_port_on_the_cpu(traffic):
    from msabench import check

    torch.set_num_threads(2)
    tr = harness.load_json("traffic", traffic)
    harness.apply_env(tr)
    spec = dict(harness.load_json("configs", "twilight48")["family"],
                n=7, lmin=50, lmax=80)
    recs = generator.family(spec, 2**35 + 1, 0)
    msa, _ = harness.program_entry(tr, "cpu")(recs)
    assert check.reference_records(tr, recs, "cpu") == msa.to_records()
