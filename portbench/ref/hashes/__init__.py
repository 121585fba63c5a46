from . import poseidon  # noqa: F401
