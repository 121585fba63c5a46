from .config import CircuitConfig  # noqa: F401
from .builder import CircuitBuilder, Wire  # noqa: F401
