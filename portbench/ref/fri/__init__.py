from .fri import FriConfig, FriProof, fri_prove, fri_verify, grind  # noqa: F401
