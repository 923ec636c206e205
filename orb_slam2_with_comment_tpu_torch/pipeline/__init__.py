from .tracking import Tracker, TrackerConfig, TrackState  # noqa: F401
from .auto import AutoTracker, AutoTrackerConfig  # noqa: F401
