from . import gl, ext  # noqa: F401
