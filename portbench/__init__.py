"""The benchmark of `plonky2_tpu_torch` on an NVIDIA H100.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once (README.md).  Every
configuration, traffic mix and metric is a file of its own that the
harness finds by the name `BENCHMARK.json` gives it.  `ref/` is the
reference the proofs are judged against: a frozen plain copy of the
port's prover that imports nothing of the port.
"""
