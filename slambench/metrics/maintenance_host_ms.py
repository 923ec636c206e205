"""The host's self time in keyframe maintenance (``_insert`` and the
``ph_*`` phases, with their children: ``_insert.bow``,
``ph_loop.covisibility``, ``ph_loop.score``) per traced frame, in ms: layer
"maintenance" of the program's span table."""
from slambench import host_spans


def read(run):
    return host_spans.layer_ms(run, "maintenance")
