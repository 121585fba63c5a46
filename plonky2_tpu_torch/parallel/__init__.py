from .mesh import Mesh, make_prover_mesh, sharded_prove_step  # noqa: F401
