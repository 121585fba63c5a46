from .hash_out import (HashOut, ZERO_HASH, from_bytes_le, from_hex,  # noqa: F401
                       hash_from_u32, hash_from_u64, hash_from_u128, key_to_bits,
                       to_bytes_le, to_hex)
from .tree import (NodeDataMemory, PoseidonNodeHash, RootDataMemory,  # noqa: F401
                   RootDataTmp, SparseMerkleTree)
from .proof import (ProcessMerkleProofRole, SparseMerkleInclusionProof,  # noqa: F401
                    SparseMerkleProcessProof, smt_lev_ins,
                    verify_smt_inclusion_proof, verify_smt_process_proof)
from .layered import (LayeredLayeredSparseMerkleTree,  # noqa: F401
                      LayeredSparseMerkleTree, verify_layered_smt_connection)
