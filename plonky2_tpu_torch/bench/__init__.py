"""Benchmark circuits: configs 1 (Poseidon chain), 2 (u32 mix), 3 (SMT
process) and 4 (secp256k1 ECDSA verify) of BASELINE.md."""

from .circuits import (build_ecdsa, build_poseidon_chain,  # noqa: F401
                       build_small_ecc, build_smt_process, build_u32_mix)
