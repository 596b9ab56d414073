"""The benchmark's registry: BENCHMARK.json at the checkout's root, and the
files each name in it leads to.

  configs/<config>.json        a configuration (named by BENCHMARK.json's
                               `file`), its sizes and its source
  traffic/<traffic>.json       a traffic mix: the driver that runs it and
                               the driver's parameters
  limits/<workload>.json       the limit of each number the cell's check
                               compares, with the readings it was set from
  metrics/<metric>.py          the reader of one metric: read(run) ->
                               float, or None where there is nothing to read
  drivers/<driver>.py          a general driver, named by a traffic mix

Nothing here knows a configuration, a mix or a metric by name: a cell is
added by adding files.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(PKG, *parts)) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic mix,
    limits and the metrics it reports."""

    def __init__(self, name: str, bench: dict | None = None,
                 root: str = ROOT):
        bench = bench if bench is not None else load_benchmark(root)
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.bench = bench
        self.workload = by_name[name]
        self.name = name
        conf = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        with open(os.path.join(root, conf["file"])) as f:
            self.config = json.load(f)
        self.traffic = _json("traffic", self.workload["traffic"] + ".json")
        lim = os.path.join(PKG, "limits", name + ".json")
        self.limits = _json("limits", name + ".json") if os.path.exists(lim) \
            else {}
        self.chips = int(self.workload["chips"])

    def metrics(self, per_layer: bool) -> list:
        """The metrics this cell reports: end-to-end with per_layer False,
        per-layer otherwise (those whose `workloads` list it, or that have
        none)."""
        key = "per_layer" if per_layer else "end_to_end"
        return [m for m in self.bench[key]
                if self.name in m.get("workloads", [self.name])]


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The read(run) function of metrics/<name>.py."""
    mod = load_module(os.path.join(PKG, "metrics", name + ".py"),
                      "perfbench_metric_" + re.sub(r"\W", "_", name))
    return mod.read


def driver_class(name: str):
    """The Driver class of drivers/<name>.py."""
    mod = importlib.import_module(f"perfbench.drivers.{name}")
    return mod.Driver
