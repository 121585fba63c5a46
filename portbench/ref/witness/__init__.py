from .witness import Generator, LambdaGenerator, generate_witness  # noqa: F401
from .hints import HINTS, NamedGenerator, hint_fn  # noqa: F401
