"""The program's counted blocking transfers (reads of device values on the
host and copies from pageable host memory, by site; ``spans.to_host`` and
``spans.to_device``) in the traced frames, per frame."""
from slambench import host_spans


def read(run):
    return host_spans.transfers_per_frame(run)
