"""Recursion: in-circuit proof verification (config 5's outer circuit).

Host copy of `plonky2_tpu/recursion/`:

* `CircuitAlg`: the circuit-emitting algebra.  Running any `Gate.eval`
  against it emits the gate's constraint evaluation as circuit targets
  (the third evaluator of gates/base.py, beside the batched prover
  algebra and the scalar verifier algebra).
* `RecursiveChallenger`: the Fiat-Shamir duplex sponge over targets,
  mirroring transcript/challenger.py observation for observation, so the
  in-circuit transcript replays the prover's challenges exactly.
* `verify_merkle_proof_to_cap_circuit`, and the verifier circuit itself
  (`verify_proof_circuit`, `add_proof_verification`, `set_proof_witness`).
"""

from .circuit_alg import CircuitAlg  # noqa: F401
from .challenger import RecursiveChallenger  # noqa: F401
from .merkle import verify_merkle_proof_to_cap_circuit  # noqa: F401
from .verifier import (  # noqa: F401
    ProofTarget,
    add_virtual_proof_target,
    add_proof_verification,
    set_proof_witness,
    verify_proof_circuit,
)
