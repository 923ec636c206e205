"""Constant numpy tables on a device, uploaded once per device.

An upload from pageable host memory is a blocking copy: a table rebuilt
on the card at every call would make the host wait on the card each
time. The cached tensors are shared, so callers only read them.
"""
from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def on_device(name: str, table: np.ndarray, device) -> torch.Tensor:
    """``table`` (a module-level constant known by ``name``) on ``device``."""
    key = (name, torch.device(device))
    t = _CACHE.get(key)
    if t is None:
        t = _CACHE[key] = torch.as_tensor(table, device=device)
    return t
