"""K1's launches over the window (the program's ``hamming.LAUNCHES``
counters), per frame."""


def read(run):
    if run.frames == 0:
        return None
    return run.launches["hamming"] / run.frames
