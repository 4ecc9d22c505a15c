"""The benchmark's data: ``BENCHMARK.json``, and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Everything else is found by name:

* ``configs/<config>.json``: the deployment (stream, engine, store,
  serving, guarantees, precision);
* ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  loop that drives it, ``traffic/<kind>.py``;
* ``checks/<cell>.json``: the limit of each number ``correct`` compares;
* ``metrics/<metric>.py`` (else ``metrics/<metric up to its first
  dot>.py``): the reader of each per-layer metric.

So a new cell, configuration, mix or metric is new files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]      # the cell's end-to-end metrics
    per_layer: List[dict]       # the cell's per-layer metrics
    limits: Dict[str, float]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        names = ", ".join(w["name"] for w in spec["workloads"])
        raise KeyError(f"no workload {name!r} (have: {names})")
    w = found[0]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = load_json(os.path.join(root, cfg["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "checks", name + ".json"))
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name)]
    for m in per_layer:
        if m["moves"] not in moves:
            raise ValueError(f"per-layer metric {m['name']!r} moves "
                             f"{m['moves']!r}, which is not an end-to-end "
                             f"metric of {name!r}")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                limits={k: float(v) for k, v in limits["limits"].items()})


def loop(kind: str):
    """The module that drives a traffic kind (``traffic/<kind>.py``)."""
    return importlib.import_module(f"chipbench.traffic.{kind}")


def reader(metric: str):
    """The ``read(view)`` function of a per-layer metric."""
    base = os.path.join(HERE, "metrics")
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(base, stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "chipbench_metric_" + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {metric!r} in {base}")


def rng_words(seed: int) -> tuple:
    """The counter RNG's key for a seed of any size."""
    seed = int(seed)
    return ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)
