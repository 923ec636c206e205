"""The host time inside the loop phase (the ``ph_loop`` span with its
children: the covisibility matrix, the BoW scores, the consistency groups,
and the Sim3 and correction where detection finds a candidate) per traced
frame, in ms. A frame that runs no loop phase adds 0."""
from slambench import host_spans


def read(run):
    got = host_spans.traced_frames(run)
    if got is None:
        return None
    _, frames = got
    ns = sum(s.duration_ns for f in frames for s in f.spans
             if s.name == "ph_loop")
    return ns / 1e6 / len(frames)
