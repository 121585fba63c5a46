from .hash_out import (HashOut, ZERO_HASH, hash_from_u32, hash_from_u64,  # noqa: F401
                       hash_from_u128, key_to_bits)
from .tree import (NodeDataMemory, PoseidonNodeHash, RootDataMemory,  # noqa: F401
                   SparseMerkleTree)
from .proof import (ProcessMerkleProofRole, SparseMerkleInclusionProof,  # noqa: F401
                    SparseMerkleProcessProof, smt_lev_ins,
                    verify_smt_inclusion_proof, verify_smt_process_proof)
from .layered import (LayeredLayeredSparseMerkleTree,  # noqa: F401
                      LayeredSparseMerkleTree, verify_layered_smt_connection)
