"""Circuit configuration presets.

Host copy of `plonky2_tpu/ir/config.py` (plonky2's `CircuitConfig`
presets).  The port hashes with Poseidon only, so the JAX config's two
hasher fields are the one constant `HASHER` (the verifier key writes it for
both), and the presets that select another hasher (keccak, poseidon2) or
serve gadgets not ported yet (the ECC presets) are left out.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fri import FriConfig

# The in-circuit and the transcript hasher of every port circuit.
HASHER = "poseidon"


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

    @staticmethod
    def standard_recursion_config() -> "CircuitConfig":
        return CircuitConfig()

    @staticmethod
    def test_config() -> "CircuitConfig":
        """Small FRI parameters for fast unit tests."""
        return CircuitConfig(
            fri=FriConfig(rate_bits=3, cap_height=2, proof_of_work_bits=8,
                          num_query_rounds=12, arity_bits=2, final_poly_bits=2))
