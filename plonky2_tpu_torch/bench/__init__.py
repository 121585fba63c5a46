"""Benchmark circuits: configs 1 (Poseidon chain), 2 (u32 mix) and 3 (SMT
process) of BASELINE.md."""

from .circuits import build_poseidon_chain, build_smt_process, build_u32_mix  # noqa: F401
