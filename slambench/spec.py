"""Where the benchmark finds its parts, by name.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; each
lives in a file of its own under this folder, as does each cell's limits
and each per-layer metric's reader:

- ``configs/<config>.json``: the deployment (camera, extractor, depth,
  map), with its ``source``, ``assumed`` and ``reduced``;
- ``traffic/<traffic>.json``: the parameters the one generator
  (``generator.py``) reads: the scene, its sizes, the warm-up and the
  window, and tracker options over the configuration's (``tracker``);
- ``scenes/<scene>.py``: a world and a camera path, with
  ``build(traffic, cfg, rng) -> (planes, poses, repeats)``;
- ``limits/<workload>.json``: each number the output check compares, with
  its limit;
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries, and edits none of these.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, here: str = HERE) -> dict:
    return _load_json(os.path.join(here, "configs", name + ".json"))


def traffic(name: str, here: str = HERE) -> dict:
    return _load_json(os.path.join(here, "traffic", name + ".json"))


def limits(workload_name: str, here: str = HERE) -> dict:
    return _load_json(os.path.join(here, "limits", workload_name + ".json"))


def _module(kind: str, name: str, here: str):
    path = os.path.join(here, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"slambench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, here: str = HERE):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _module("metrics", metric, here).read


def scene(name: str, here: str = HERE):
    """The ``build`` function of ``scenes/<name>.py``."""
    return _module("scenes", name, here).build


def metrics_of(bench: dict, workload_name: str, section: str) -> list:
    """The entries of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those without a ``workloads`` key, and those that list
    it."""
    return [m for m in bench[section]
            if workload_name in m.get("workloads", [workload_name])]
