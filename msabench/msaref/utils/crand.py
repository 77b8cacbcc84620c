# Frozen copy of mlprobs_tpu_torch/utils/crand.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""glibc rand() emulation (TYPE_3 additive-feedback generator).

The reference's iterative refinement partitions sequences with bare
`rand() % 2` and never seeds the PRNG in the progressive path
(MSA.cpp:1545), so every run uses glibc's default seed 1.  Reproducing
the byte-exact sequence keeps our refinement bipartitions — and hence
final alignments — aligned with the reference.
"""
from __future__ import annotations


class GlibcRand:
    """Exact glibc rand() sequence for a given seed."""

    def __init__(self, seed: int = 1):
        r = [0] * 344
        r[0] = seed & 0xFFFFFFFF
        word = seed
        for i in range(1, 31):
            # minstd step computed the glibc way (Schrage's trick)
            hi, lo = divmod(word, 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        self._r = r
        self._idx = 344 - 1

    def rand(self) -> int:
        r = self._r
        self._idx += 1
        r.append((r[self._idx - 31] + r[self._idx - 3]) & 0xFFFFFFFF)
        return r[self._idx] >> 1
