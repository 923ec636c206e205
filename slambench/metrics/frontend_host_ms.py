"""The host's self time in the front end (the ``frontend`` span and its
children: ``frontend.pyramid``, ``frontend.extract``, ``frontend.depth``)
per traced frame, in ms: layer "front end" of the program's span table."""
from slambench import host_spans


def read(run):
    return host_spans.layer_ms(run, "front end")
