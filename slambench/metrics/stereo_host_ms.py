"""The host's self time in the stereo front end (``stereo.match``: the
association mask, K1 and K5) per traced frame, in ms: layer "stereo front
end" of the program's span table."""
from slambench import host_spans


def read(run):
    return host_spans.layer_ms(run, "stereo front end")
