"""BENCHMARK.json and the files it names, found by name.

  configs/<config>.json     a deployment: sizes and precisions
  traffic/<mix>.json        a traffic mix; its "kind" picks the driver
                            loops/<kind>.py (class `Cell`)
  limits/<cell>.json        the numbers `correct` compares in the cell, each
                            with its limit (PERF.md gives their readings)
  metrics/<metric>.py       a metric's reader: `read(run) -> float | None`

A new configuration, mix, cell or metric is new files and new entries in
BENCHMARK.json; nothing here lists them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def limits(cell: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        return json.load(f)


def cell_class(kind: str):
    return importlib.import_module(f"benchmark.loops.{kind}").Cell


def reader(metric: str):
    """The `read` function of metrics/<metric>.py (a name may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics this cell reports: those whose `workloads` list it."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]
