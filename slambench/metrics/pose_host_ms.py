"""The host's self time in the pose solves (``_pose_optimize_from_matches``)
per traced frame, in ms: layer "pose" of the program's span table."""
from slambench import host_spans


def read(run):
    return host_spans.layer_ms(run, "pose")
