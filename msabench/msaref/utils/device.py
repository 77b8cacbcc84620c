# Frozen copy of mlprobs_tpu_torch/utils/device.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Device selection: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The torch device to run on; raises if CUDA is asked for and absent.

    There is no "cuda if available": a run that wants the card and cannot
    have it fails loudly instead of running on the host.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
