"""Finding a cell's pieces by name.

`BENCHMARK.json` at the root names the cells, configurations and metrics.
Each piece lives in a file of its own under `benchmark/`, found by its name:

  configs/<config>.json   the configuration as it is run ("circuit" names it)
  traffic/<traffic>.json  the traffic mix's parameters ("entry" names the
                          kind of work: a check, a proof)
  runners/<circuit>_<entry>.py   drives the program for that work
  metrics/<metric>.py     reads one metric: read(ctx) -> float or None

A later change adds a configuration, a cell or a metric by adding files and
entries; no file here needs an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = "benchmark"


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str, root: str = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, BENCH, "traffic", f"{name}.json")) as f:
        return json.load(f)


def runner(circuit: str, entry: str):
    """the runner class for this kind of work on this circuit."""
    return importlib.import_module(f"{BENCH}.runners.{circuit}_{entry}").Runner


def metrics(spec: dict, cell_name: str, kind: str) -> list:
    """the metric entries of `kind` ("end_to_end" or "per_layer") that this
    cell reports: those that list it, and those that list no cells."""
    return [m for m in spec[kind] if cell_name in m.get("workloads", [cell_name])]


def reader(name: str, root: str = ROOT):
    """the read(ctx) function of metrics/<name>.py."""
    path = os.path.join(root, BENCH, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(f"{BENCH}_metric_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
