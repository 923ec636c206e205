"""The host's blocking calls (stream, device and event synchronizes and
synchronous copies, from the profiler's runtime events) inside the traced
frames, per frame."""


def read(run):
    if run.trace is None or run.trace.frames == 0:
        return None
    return run.trace.host_waits / run.trace.frames
