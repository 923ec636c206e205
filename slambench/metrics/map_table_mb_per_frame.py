"""The bytes the map's table-wide passes read, per traced frame, in MB
(1e6 bytes): the program's ``table_bytes`` counter of each frame record,
summed over its sites (``spans.table_read``: the local landmark mask, the
covisibility weights and matrix, the BoW scores and clone, the landmark
sweeps of tracking, local BA, merging and culling, the compactions). A
program without the counter gives None."""
from slambench import host_spans


def read(run):
    got = host_spans.traced_frames(run)
    if got is None:
        return None
    _, frames = got
    if not all(hasattr(f, "table_bytes") for f in frames):
        return None
    return sum(sum(f.table_bytes.values()) for f in frames) / 1e6 / len(
        frames)
