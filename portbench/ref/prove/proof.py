"""Proof containers (host-side, serializable).

Host copy of `plonky2_tpu/prove/proof.py` (plonky2's
`ProofWithPublicInputs` shape): wire/Z/quotient caps, the opening set at
zeta (and g*zeta for the Z polynomials), and the FRI proof.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class OpeningSet:
    constants_sigmas: list   # [(c0, c1)] — selectors | constants | sigmas
    wires: list
    zs_partial_products: list
    zs_next: list            # Z polys at g*zeta
    quotient: list

    def observe_order(self):
        """Flattened observation order shared by prover and verifier."""
        return (self.constants_sigmas + self.wires + self.zs_partial_products
                + self.zs_next + self.quotient)


@dataclass
class Proof:
    wires_cap: list
    zs_pp_cap: list
    quotient_cap: list
    openings: OpeningSet
    fri: object              # FriProof
    public_inputs: list = field(default_factory=list)
