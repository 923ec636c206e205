"""PyTorch + CUDA port of orb_slam2_with_comment_tpu: the System façade,
the host-driven and the autonomous trackers (RGB-D, stereo, monocular),
loop closing and relocalization, on a hand-written Hopper Hamming kernel."""

from .system import Sensor, System  # noqa: E402,F401
