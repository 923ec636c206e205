"""The host's self time in the four tracking searches
(``_match_motion_model`` twice, ``_match_reference_kf``,
``track_local_map``, with their ``search.mask`` and ``search.match``) per
traced frame, in ms: layer "matching" of the program's span table."""
from slambench import host_spans


def read(run):
    return host_spans.layer_ms(run, "matching")
