"""mlprobs_tpu_torch — the MLProbs engine on PyTorch and CUDA.

The port of `mlprobs_tpu` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA
H100.  It keeps the JAX package's module names (`core/`, `models/`,
`ops/`, `align/`, `pipeline/`, `utils/`) so that each counterpart is easy
to find, and it imports nothing of the JAX package: every module it
needs is its own copy.

The posterior stage runs on two hand-written CUDA kernels
(`ops/kernels/csrc/sweep.cu`, `combine.cu`), built with nvcc at first use.
Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU, where the kernels' plain PyTorch versions run instead.
"""

__version__ = "0.1.0"
