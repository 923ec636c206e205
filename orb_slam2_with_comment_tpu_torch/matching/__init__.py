from . import core, search  # noqa: F401
