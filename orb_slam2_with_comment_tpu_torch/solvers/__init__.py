from . import horn, initializer, pnp, sim3solver  # noqa: F401
