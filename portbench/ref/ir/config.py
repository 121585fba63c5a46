"""Circuit configuration presets.

Host copy of `plonky2_tpu/ir/config.py` (plonky2's `CircuitConfig`
presets), with its two hasher fields: the in-circuit hasher (Poseidon or
Poseidon2, the gate `permute` emits and the public-input hash) and the
transcript hasher (Poseidon or Keccak: the Merkle trees, the Fiat-Shamir
transcript and the proof-of-work grind).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fri import FriConfig

ALGEBRAIC_HASHERS = ("poseidon", "poseidon2")
TRANSCRIPT_HASHERS = ("poseidon", "keccak")


@dataclass(frozen=True)
class CircuitConfig:
    num_wires: int = 135
    num_routed_wires: int = 80
    num_constants: int = 2
    num_challenges: int = 2
    security_bits: int = 100
    # max degree of a filtered constraint; the quotient splits into this
    # many degree-n chunks
    max_quotient_degree_factor: int = 8
    fri: FriConfig = field(default_factory=FriConfig)
    # in-circuit ("inner") algebraic hasher: "poseidon" | "poseidon2"
    algebraic_hasher: str = "poseidon"
    # transcript / Merkle ("outer") hasher: "poseidon" | "keccak", the
    # KeccakGoldilocksConfig slot the reference proves Keccak circuits under
    transcript_hasher: str = "poseidon"

    def __post_init__(self):
        if self.algebraic_hasher not in ALGEBRAIC_HASHERS:
            raise ValueError(f"algebraic_hasher {self.algebraic_hasher!r} is not one of "
                             f"{ALGEBRAIC_HASHERS}")
        if self.transcript_hasher not in TRANSCRIPT_HASHERS:
            raise ValueError(f"transcript_hasher {self.transcript_hasher!r} is not one of "
                             f"{TRANSCRIPT_HASHERS}")

    def hasher_module(self):
        from ..hashes import poseidon, poseidon2
        return poseidon2 if self.algebraic_hasher == "poseidon2" else poseidon

    def transcript_module(self):
        from ..hashes import keccak_hash, poseidon
        return keccak_hash if self.transcript_hasher == "keccak" else poseidon

    @staticmethod
    def standard_recursion_config() -> "CircuitConfig":
        return CircuitConfig()

    @staticmethod
    def keccak_config() -> "CircuitConfig":
        """KeccakGoldilocksConfig: the Keccak transcript and Merkle hasher,
        Poseidon in-circuit (the reference's Keccak-256 circuits)."""
        return CircuitConfig(transcript_hasher="keccak")

    @staticmethod
    def standard_ecc_config() -> "CircuitConfig":
        """plonky2's preset for the secp256k1 circuits (config 4): 136
        wires, 80 routed."""
        return CircuitConfig(num_wires=136)

    @staticmethod
    def wide_ecc_config() -> "CircuitConfig":
        return CircuitConfig(num_wires=234, num_routed_wires=80)

    @staticmethod
    def poseidon2_config() -> "CircuitConfig":
        """standard_recursion_config with Poseidon2 as the in-circuit
        hasher (the Poseidon2GoldilocksConfig slot)."""
        return CircuitConfig(algebraic_hasher="poseidon2")

    @staticmethod
    def test_config() -> "CircuitConfig":
        """Small FRI parameters for fast unit tests."""
        return CircuitConfig(
            fri=FriConfig(rate_bits=3, cap_height=2, proof_of_work_bits=8,
                          num_query_rounds=12, arity_bits=2, final_poly_bits=2))
