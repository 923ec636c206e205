from . import image, fast, orientation, brief, hamming  # noqa: F401
