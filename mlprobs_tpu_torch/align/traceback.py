"""Host-side traceback over an MWT direction matrix.

Path encoding matches the reference alignment strings
(ProbabilisticModel.h ComputeAlignment): 0 = 'B' (both), 1 = 'X'
(residue from x only), 2 = 'Y' (from y only).
"""
from __future__ import annotations

import numpy as np

from mlprobs_tpu_torch.utils import host

B, X, Y = 0, 1, 2


def mwt_traceback(dirs: np.ndarray, lx: int, ly: int) -> np.ndarray:
    """Follow an MWT direction matrix (0=diag,1=left,2=up) from (lx, ly).

    Returns the path as int8 codes in forward order.
    """
    return host.mwt_traceback(dirs, lx, ly)
