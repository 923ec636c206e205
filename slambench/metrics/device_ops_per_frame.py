"""Device operations (kernels, copies, sets) in the traced stretch, per
frame."""


def read(run):
    if run.trace is None or run.trace.frames == 0:
        return None
    return run.trace.device_ops / run.trace.frames
