"""K4's device time in the traced frames (kernels named as in
csrc/ba.cu), per frame, in ms."""


def read(run):
    if run.trace is None or run.trace.frames == 0:
        return None
    return 1000.0 * run.trace.kernel_s.get("ba", 0.0) / run.trace.frames
