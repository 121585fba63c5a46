"""Benchmark circuits: configs 1 (Poseidon chain), 2 (u32 mix), 3 (SMT
process), 4 (secp256k1 ECDSA verify) and 5 (aggregation of 4 zkDSA
proofs) of BASELINE.md, and the lookup circuits `mixed_small` and
`lookup8`."""

from .circuits import (build_aggregation, build_ecdsa,  # noqa: F401
                       build_lookup_bytes, build_mixed_small,
                       build_poseidon_chain, build_small_ecc,
                       build_smt_process, build_u32_mix)
