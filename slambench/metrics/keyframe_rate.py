"""Keyframes inserted in the window per frame (the trajectory's
per-frame insert flag): whether the mix does what its cell says."""


def read(run):
    if run.frames == 0:
        return None
    return run.inserted / run.frames
