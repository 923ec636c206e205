"""Streaming nodes: callback-driven live ingestion (port of nodes.py).

The reference's ROS wrappers (Examples/ROS/ORB_SLAM2/src/ros_mono.cc,
ros_stereo.cc, ros_rgbd.cc) subscribe to image topics, pair stereo or
RGB-D messages with an approximate-time synchronizer, optionally rectify
the stereo pair, and call System::Track* from the callback. Here the
transport is any Python callable source; each node exposes ``on_*``
callbacks with the same pairing semantics and drives a System.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable

import numpy as np

from .system import System


@dataclass
class NodeStats:
    frames_in: int = 0
    frames_tracked: int = 0
    frames_dropped: int = 0  # unpaired or stale messages


class MonoNode:
    """Monocular node (ros_mono.cc ImageGrabber::GrabImage): ``on_image``
    tracks at once; ``pose_callback(timestamp, pose)`` gets every tracked
    pose."""

    def __init__(self, system: System,
                 pose_callback: Callable | None = None):
        self.system = system
        self.pose_callback = pose_callback
        self.stats = NodeStats()

    def on_image(self, img: np.ndarray, timestamp: float) -> bool:
        self.stats.frames_in += 1
        out = self.system.track_monocular(img, timestamp)
        if out is None:
            return False
        self.stats.frames_tracked += 1
        if self.pose_callback is not None:
            self.pose_callback(timestamp, out)
        return True


class _PairingQueue:
    """Approximate-time pairing of two streams (message_filters'
    ApproximateTime policy): a pair fires when the front timestamps agree
    within ``slop`` seconds; the older unmatched message is dropped."""

    def __init__(self, slop: float = 0.02, maxlen: int = 8):
        self.slop = slop
        self.a: deque = deque(maxlen=maxlen)
        self.b: deque = deque(maxlen=maxlen)
        self.dropped = 0

    def push(self, side: str, ts: float, payload) -> tuple | None:
        (self.a if side == "a" else self.b).append((ts, payload))
        return self._try_match()

    def _try_match(self):
        while self.a and self.b:
            ta, pa = self.a[0]
            tb, pb = self.b[0]
            if abs(ta - tb) <= self.slop:
                self.a.popleft()
                self.b.popleft()
                return (min(ta, tb), pa, pb)
            if ta < tb:
                self.a.popleft()
            else:
                self.b.popleft()
            self.dropped += 1
        return None


class StereoNode:
    """Stereo node with optional online rectification (ros_stereo.cc's
    do_rectify branch): pass a dataio.rectify.StereoRectifier for raw
    pairs, None for rectified streams."""

    def __init__(self, system: System, rectifier=None, slop: float = 0.02,
                 pose_callback: Callable | None = None):
        self.system = system
        self.rectifier = rectifier
        self.queue = _PairingQueue(slop=slop)
        self.pose_callback = pose_callback
        self.stats = NodeStats()

    def on_left(self, img: np.ndarray, timestamp: float) -> bool:
        return self._feed("a", img, timestamp)

    def on_right(self, img: np.ndarray, timestamp: float) -> bool:
        return self._feed("b", img, timestamp)

    def _feed(self, side, img, ts) -> bool:
        self.stats.frames_in += side == "a"
        pair = self.queue.push(side, ts, img)
        self.stats.frames_dropped = self.queue.dropped
        if pair is None:
            return False
        ts0, left, right = pair
        if self.rectifier is not None:
            left, right = self.rectifier(left, right)
        out = self.system.track_stereo(left, right, ts0)
        if out is None:
            return False
        self.stats.frames_tracked += 1
        if self.pose_callback is not None:
            self.pose_callback(ts0, out)
        return True


class RGBDNode:
    """RGB-D node (ros_rgbd.cc): pairs color and depth messages and calls
    TrackRGBD; ``depth_factor`` divides raw depth into meters
    (DepthMapFactor, Tracking.cc:144-148)."""

    def __init__(self, system: System, slop: float = 0.02,
                 depth_factor: float = 1.0,
                 pose_callback: Callable | None = None):
        self.system = system
        self.queue = _PairingQueue(slop=slop)
        self.depth_factor = depth_factor
        self.pose_callback = pose_callback
        self.stats = NodeStats()

    def on_rgb(self, img: np.ndarray, timestamp: float) -> bool:
        return self._feed("a", img, timestamp)

    def on_depth(self, depth: np.ndarray, timestamp: float) -> bool:
        return self._feed("b", depth, timestamp)

    def _feed(self, side, payload, ts) -> bool:
        self.stats.frames_in += side == "a"
        pair = self.queue.push(side, ts, payload)
        self.stats.frames_dropped = self.queue.dropped
        if pair is None:
            return False
        ts0, img, depth = pair
        if self.depth_factor != 1.0:
            depth = np.asarray(depth, np.float32) / self.depth_factor
        out = self.system.track_rgbd(img, depth, ts0)
        if out is None:
            return False
        self.stats.frames_tracked += 1
        if self.pose_callback is not None:
            self.pose_callback(ts0, out)
        return True
