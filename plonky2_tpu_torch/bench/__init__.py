"""Benchmark circuits: configs 1 (Poseidon chain) and 3 (SMT process) of
BASELINE.md."""

from .circuits import build_poseidon_chain, build_smt_process  # noqa: F401
