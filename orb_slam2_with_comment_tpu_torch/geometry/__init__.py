from . import se3, sim3, triangulate  # noqa: F401
