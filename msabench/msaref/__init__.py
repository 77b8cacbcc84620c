"""The benchmark's plain reference of the MLProbs pipeline.

A frozen copy of `mlprobs_tpu_torch` at commit 30598a0, cut to the
modules that `pipeline.driver.run_pipeline` and `align.aligner.
align_family` reach, with every computation of the port's hand-written
code replaced by its plain version:

* the CUDA kernels (sweep, combine, viterbi, qpx) by the plain PyTorch
  loops over diagonals that the port keeps beside them
  (`ops/plain.py`, which wraps `ops/wavefront.py` and `ops/qpx.py`);
* the C++ host helpers of the merge (MWT fill, traceback, weighted
  profile-posterior scatter) by NumPy (`utils/host.py`, the JAX
  package's NumPy path, which the port's C++ equals bit for bit);
* the pairs mesh by nothing: the reference runs on one device.

It imports neither `jax`, the JAX package nor the port, and reads only
its own copy of the model parameters and forests (`models/assets/`).
Runs on the card after the measured window (plain PyTorch on
`device="cuda"`) or on the CPU in the tests.  Three switches serve the
control of the benchmark's correctness check, all off by default:
`align.consistency.ALLOW_TF32` (the relaxation's contraction in TF32),
`align.pairwise.POSTERIOR_DTYPE` (the dense posterior planes stored in a
lower precision) and `utils.host.PLANE_BF16` (the merge's profile
posteriors rounded to bfloat16).
"""
