"""Benchmark circuits: configs 1 (Poseidon chain), 2 (u32 mix), 3 (SMT
process), 4 (secp256k1 ECDSA verify) and 5 (aggregation of 4 zkDSA
proofs) of BASELINE.md, and the lookup circuits `mixed_small` and
`lookup8`; `kernel_launches()`, the hand-written kernels' launch
counts."""

from .circuits import (build_aggregation, build_ecdsa,  # noqa: F401
                       build_lookup_bytes, build_mixed_small,
                       build_poseidon_chain, build_small_ecc,
                       build_smt_process, build_u32_mix)


def kernel_launches() -> dict:
    """{kernel: launches so far in this process}: each kernel wrapper adds
    one where it launches its kernel."""
    from ..hashes import cuda_poseidon
    from ..ntt import cuda_lde, cuda_lde_tiled
    return {"K1": cuda_poseidon.LAUNCHES, "K2-rev": cuda_lde.LAUNCHES,
            "K2-nat": cuda_lde.LAUNCHES_NAT, "K3": cuda_lde_tiled.LAUNCHES}
