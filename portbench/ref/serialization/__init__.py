from .buffer import Buffer  # noqa: F401
from .serde import (deserialize_proof, deserialize_verifier_data,  # noqa: F401
                    gate_from_key, serialize_proof, serialize_verifier_data)
from .prover_serde import deserialize_prover_data, serialize_prover_data  # noqa: F401
