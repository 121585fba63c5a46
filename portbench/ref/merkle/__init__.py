from .merkle import MerkleTree, ShardedMerkleTree, verify_merkle_proof_s  # noqa: F401
