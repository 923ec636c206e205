from .extractor import OrbExtractor, FrameFeatures  # noqa: F401
