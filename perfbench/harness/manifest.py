"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); a per-layer metric ``<name>`` is read
by ``metrics/<name>.py``, which may name the spans it reads in
``SPANS`` ({method of the pipeline: span name}). The mix names its
source and runner, the configuration its architectures and tracker, each
a file of its own (named.py). Adding a cell, a configuration, a mix or a
metric adds files and entries; no code here changes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List

from perfbench.named import by_name


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json, with its "name"
    traffic: dict           # traffic/<traffic>.json, with its "name"
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]   # ... and with --trace 1


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: str, workload: str) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    return make_cell(root, bench, workload, w["config"], w["traffic"],
                     int(w["chips"]))


def make_cell(root: str, bench: dict, name: str, config: str, mix: str,
              chips: int = 1) -> Cell:
    """A cell of configuration ``config`` under the traffic mix ``mix``,
    with the metrics ``bench`` gives a cell of that name."""
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[config]["file"])) as f:
        cfg = dict(json.load(f), name=config)
    with open(os.path.join(root, "perfbench", "traffic",
                           mix + ".json")) as f:
        traffic = dict(json.load(f), name=mix)
    return Cell(
        name=name, chips=chips, config=cfg, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def metric(root: str, name: str):
    """The reader of metric ``name``: ``metrics/<name>.py`` of ``root``'s
    perfbench/."""
    return by_name("metrics", name, os.path.join(root, "perfbench"))


def spans(root: str, metrics: List[dict]) -> Dict[str, str]:
    """{method of the pipeline: span name} that the metrics read."""
    out: Dict[str, str] = {}
    for m in metrics:
        out.update(getattr(metric(root, m["name"]), "SPANS", {}))
    return out


def read_metrics(root: str, metrics: List[dict],
                 reading) -> Dict[str, dict]:
    """Each metric's reader over one traced run; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = metric(root, m["name"]).read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
