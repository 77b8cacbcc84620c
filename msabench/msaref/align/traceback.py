# Frozen copy of mlprobs_tpu_torch/align/traceback.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Host-side tracebacks over direction matrices.

Path encoding matches the reference alignment strings
(ProbabilisticModel.h ComputeAlignment / ComputeViterbiAlignment):
0 = 'B' (both), 1 = 'X' (residue from x only), 2 = 'Y' (from y only).
"""
from __future__ import annotations

import numpy as np

from msabench.msaref.utils import host

B, X, Y = 0, 1, 2


def mwt_traceback(dirs: np.ndarray, lx: int, ly: int) -> np.ndarray:
    """Follow an MWT direction matrix (0=diag,1=left,2=up) from (lx, ly).

    Returns the path as int8 codes in forward order.
    """
    return host.mwt_traceback(dirs, lx, ly)


def viterbi_traceback(
    dirs: np.ndarray, end_state: int, lx: int, ly: int
) -> np.ndarray:
    """Follow packed Viterbi direction bits from (lx, ly).

    dirs bit layout: bits 0-1 = M predecessor state, bit 2 = X-from-X,
    bit 3 = Y-from-Y (see ops/viterbi.py).  Returns the path as int8
    codes in forward order.
    """
    out = []
    r, c = lx, ly
    state = int(end_state)
    while r != 0 or c != 0:
        d = int(dirs[r, c])
        if state == 0:
            nxt = d & 3
            r -= 1
            c -= 1
            out.append(B)
        elif state == 1:
            nxt = 1 if (d & 4) else 0
            r -= 1
            out.append(X)
        else:
            nxt = 2 if (d & 8) else 0
            c -= 1
            out.append(Y)
        state = nxt
    return np.array(out[::-1], dtype=np.int8)
