from .challenger import Challenger  # noqa: F401
