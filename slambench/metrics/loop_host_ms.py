"""The host's self time in the rest of the ``frame`` span (the upload, the
decisions, the state and trajectory writes) per traced frame, in ms: layer
"tracker host loop" of the program's span table."""
from slambench import host_spans


def read(run):
    return host_spans.layer_ms(run, "tracker host loop")
