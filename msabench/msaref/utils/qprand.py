# Frozen copy of mlprobs_tpu_torch/utils/qprand.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""QuickProbs-exact deterministic random streams.

The reference replaced all nondeterministic RNG with two pieces so CPU,
GPU and threaded runs agree (Common/deterministic_random.{h,cpp},
Kernels/Random.cl):

* a default-constructed ``std::mt19937`` (seed 5489) driving
  ``det_uniform_int_distribution`` — numpy's legacy ``RandomState``
  uses the same init_genrand seeding, so the raw 32-bit stream matches
  bit for bit (verified against the well-known mt19937(5489) outputs);
* a tiny Lehmer generator ``parkmiller(seed) = seed * 75 % 65537``
  (NOT the 16807 minimal standard; the reference reuses the name)
  whose outputs, scaled by ``RND_MAX_INV``, gate the consistency
  z-acceptance (ConsistencyStage.cpp:155-221).
"""
from __future__ import annotations

import numpy as np

RND_MAX = 65536                    # deterministic_random.h:10
RND_MAX_INV = np.float32(0.000015298473212373405134167610072515)
_PM_A = 75
_PM_M = RND_MAX + 1                # 65537 (Fermat prime)


def parkmiller75(seed: int) -> int:
    """deterministic_random.cpp:4-11 (also Kernels/Random.cl)."""
    return (seed * _PM_A) % _PM_M


class Mt19937Stream:
    """Raw 32-bit draws identical to a default std::mt19937."""

    def __init__(self, seed: int = 5489):
        self._rs = np.random.RandomState(seed)

    def raw(self) -> int:
        return int(self._rs.randint(0, 2 ** 32, dtype=np.uint32))

    def det_uniform_int(self, lo: int, hi: int) -> int:
        """det_uniform_int_distribution<int>(lo, hi)(engine).

        Modulo with rejection of the top sliver, exactly as
        deterministic_random.h:128-141 (diff_type = unsigned int).
        """
        diff = (hi - lo + 1) & 0xFFFFFFFF
        if diff == 0:
            return self.raw()
        bad_limit = 0xFFFFFFFF // diff
        while True:
            g = self.raw()
            if g // diff < bad_limit:
                return (g % diff) + lo


def consistency_seed_matrix(n: int) -> np.ndarray:
    """The per-pair seed table of ConsistencyStage::doRelaxation.

    seeds[i*n+j] drawn row-major from det_uniform(0, RND_MAX) over a
    default mt19937 (ConsistencyStage.cpp:155-160).  Note the engine is
    re-default-constructed for every relaxation call, so every round
    uses the same table.
    """
    eng = Mt19937Stream()
    seeds = np.empty(n * n, dtype=np.int64)
    for k in range(n * n):
        seeds[k] = eng.det_uniform_int(0, RND_MAX)
    return seeds.reshape(n, n)


def seed_selection_ids(n: int, count: int) -> np.ndarray:
    """Seed-mode selectivity ids (ExtendedMSA.cpp:115-123):
    `count` draws of det_uniform(0, n-1) from a default mt19937."""
    eng = Mt19937Stream()
    return np.array(
        [eng.det_uniform_int(0, n - 1) for _ in range(count)],
        dtype=np.int64,
    )


def z_accept_row(
    seed: int, x_filtered: np.ndarray
) -> np.ndarray:
    """Acceptance bits for the z-loop of one pair.

    For k = 0..len-1 (the reference loops all z != i, j in index
    order): seed <- parkmiller75(seed); accept iff
    float(seed) * RND_MAX_INV - x < 0 (ConsistencyStage.cpp:186-221).
    The same seed sequence is replayed for the accept-count pass and
    the relax pass, so one evaluation serves both.
    """
    out = np.zeros(len(x_filtered), dtype=bool)
    s = seed
    for k in range(len(x_filtered)):
        s = parkmiller75(s)
        out[k] = (
            np.float32(s) * RND_MAX_INV - np.float32(x_filtered[k]) < 0
        )
    return out
