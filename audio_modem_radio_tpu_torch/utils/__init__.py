from . import compression, wavio  # noqa: F401
