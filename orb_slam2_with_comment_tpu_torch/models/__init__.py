from .camera import PinholeCamera, StereoCamera  # noqa: F401
