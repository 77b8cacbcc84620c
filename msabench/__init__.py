"""msabench: the benchmark of mlprobs_tpu_torch on one NVIDIA H100.

`python3 -m msabench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` aligns seeded protein families back to back for `s`
seconds through the cell's entry point and prints one JSON line.  The
cells are in BENCHMARK.json at the checkout's root; everything a cell
names is found by name under this folder (README.md).
"""
