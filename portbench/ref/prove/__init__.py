from .compile import CircuitData, compile_circuit  # noqa: F401
from .prover import prove  # noqa: F401
