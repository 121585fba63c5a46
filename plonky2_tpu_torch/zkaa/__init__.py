"""zkAA: recursive proof aggregation (config 5 of BASELINE.md).

Host copy of `plonky2_tpu/zkaa/__init__.py`.  An aggregation circuit embeds
N in-circuit proof verifiers (recursion/verifier.py) for one inner circuit
shape and re-exposes the inner public inputs concatenated, so one outer
proof attests to N inner proofs.  `aggregation_builder` is the outer
builder before its build (its graph digest is held against the JAX
package's without a build) and `aggregation_witness` binds inner proofs
to its proof targets; `make_aggregation_circuit` builds it on `device`,
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ir import CircuitBuilder, CircuitConfig
from ..recursion import add_proof_verification, set_proof_witness
from ..utils.device import DEFAULT_DEVICE


@dataclass
class AggregationCircuit:
    data: object                 # outer CircuitData
    proof_targets: list          # list[ProofTarget], one per inner slot
    inner_verifier: object       # the inner VerifierData these slots verify

    @property
    def num_slots(self) -> int:
        return len(self.proof_targets)

    def witness(self, inner_proofs: list) -> dict:
        """The outer circuit's inputs: each inner proof bound to its slot."""
        return aggregation_witness(self.proof_targets, inner_proofs)

    def prove(self, inner_proofs: list):
        """inner_proofs: host Proof objects (must verify against
        `inner_verifier`).  Returns the outer proof, whose public inputs
        are the inner proofs' public inputs concatenated."""
        return self.data.prove(self.witness(inner_proofs))

    def verify(self, outer_proof) -> None:
        self.data.verify(outer_proof)


def aggregation_witness(proof_targets: list, inner_proofs: list) -> dict:
    """The outer circuit's inputs: each inner proof bound to its slot's
    proof targets."""
    if len(inner_proofs) != len(proof_targets):
        raise ValueError(f"{len(inner_proofs)} proofs for "
                         f"{len(proof_targets)} slots")
    inputs: dict = {}
    for pt, proof in zip(proof_targets, inner_proofs):
        set_proof_witness(inputs, pt, proof)
    return inputs


def aggregation_builder(inner_vd, num_proofs: int = 4, config=None):
    """The outer circuit's builder, not yet built, and its proof targets."""
    b = CircuitBuilder(config or CircuitConfig.standard_recursion_config())
    pts = []
    for _ in range(num_proofs):
        pt = add_proof_verification(b, inner_vd)
        b.register_public_inputs(pt.public_inputs)
        pts.append(pt)
    return b, pts


def make_aggregation_circuit(inner_vd, num_proofs: int = 4, config=None,
                             device=DEFAULT_DEVICE) -> AggregationCircuit:
    """Build a circuit verifying `num_proofs` proofs of the circuit
    described by `inner_vd` (config 5 uses 4 zkDSA proofs)."""
    b, pts = aggregation_builder(inner_vd, num_proofs, config)
    return AggregationCircuit(data=b.build(device=device), proof_targets=pts,
                              inner_verifier=inner_vd)
