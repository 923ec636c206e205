from .map import MapState, MapConfig  # noqa: F401
