"""Finds a cell's parts by name, so that a new cell, configuration, traffic
mix, route or metric is new files and new entries only.

- ``BENCHMARK.json`` (the checkout's root): the cells, their configuration
  and traffic names, and the metrics;
- ``configs/<config>.json``: the sizes as run, the source, the cuts, the
  deployment it stands for and the serve ``route``;
- ``traffic/<traffic>.json``: the parameters of one traffic mix, read by
  the generator ``traffic/<generator>.py`` that it names;
- ``workloads/<cell>.json``: what belongs to one cell alone, the limits of
  the numbers that decide ``correct`` and the readings they were set from;
- ``routes/<route>.py``: how a configuration is built and served through
  the port;
- ``metrics/<metric>.py``: one reader per metric, with ``UNIT``,
  ``BETTER``, ``LAYER``, ``MOVES`` and ``read(ctx)``.

A cell reports every metric whose reader finds something to read in its
run; a metric named ``<name>.b<N>`` is read only in cells whose traffic
sends batches of N. So a new cell reports the metrics there are without
an edit to their files or entries.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Registry:
    """The benchmark rooted at ``root`` (a checkout holding
    ``BENCHMARK.json`` and the harness's directory ``pkg``)."""

    def __init__(self, root=None, pkg=None):
        self.pkg = Path(pkg) if pkg is not None else HERE
        self.root = Path(root) if root is not None else self.pkg.parent
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)
        self._modules = {}

    # ---------------------------------------------------------------- data
    def cell(self, name: str) -> dict:
        """The ``workloads`` entry of ``name`` merged with
        ``workloads/<name>.json``; the two must agree on config and
        traffic."""
        entries = [w for w in self.spec["workloads"] if w["name"] == name]
        if not entries:
            known = ", ".join(w["name"] for w in self.spec["workloads"])
            raise KeyError(f"no cell {name!r} in BENCHMARK.json ({known})")
        cell = dict(entries[0])
        extra = self._json("workloads", name)
        for key in ("config", "traffic"):
            if extra.get(key, cell[key]) != cell[key]:
                raise ValueError(f"workloads/{name}.json names {key} "
                                 f"{extra[key]!r}, BENCHMARK.json "
                                 f"{cell[key]!r}")
        cell.update({k: v for k, v in extra.items() if k not in cell})
        return cell

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def _json(self, folder: str, name: str) -> dict:
        path = self.pkg / folder / f"{name}.json"
        with open(path) as f:
            return json.load(f)

    # ---------------------------------------------------------------- code
    def module(self, folder: str, name: str):
        """``<pkg>/<folder>/<name>.py`` as a module (names may hold dots,
        so it is loaded from its path)."""
        key = (folder, name)
        if key not in self._modules:
            path = self.pkg / folder / f"{name}.py"
            if not path.exists():
                raise KeyError(f"no {folder}/{name}.py")
            mod_name = re.sub(r"\W", "_", f"portbench_{folder}_{name}")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def generator(self, traffic: dict):
        return self.module("traffic", traffic["generator"])

    def route(self, config: dict):
        return self.module("routes", config["route"])

    def metric(self, name: str):
        return self.module("metrics", name)

    # ------------------------------------------------------------- metrics
    def metrics(self, cell: str, kind: str) -> list:
        """The entries of ``end_to_end`` or ``per_layer`` whose readers
        ``cell``'s runs call: all of them, but one named ``<name>.b<N>``
        only where the cell's traffic sends batches of N."""
        batch = self.traffic(self.cell(cell)["traffic"])["batch"]
        out = []
        for m in self.spec[kind]:
            sized = re.search(r"\.b(\d+)$", m["name"])
            if sized is None or int(sized.group(1)) == batch:
                out.append(m)
        return out

    def plan(self, cell_name: str) -> dict:
        """Everything one run of the cell needs, resolved by name."""
        cell = self.cell(cell_name)
        config = self.config(cell["config"])
        traffic = self.traffic(cell["traffic"])
        return {
            "cell": cell, "config": config, "traffic": traffic,
            "generator": self.generator(traffic),
            "route": self.route(config),
            "end_to_end": {m["name"]: self.metric(m["name"])
                           for m in self.metrics(cell_name, "end_to_end")},
            "per_layer": {m["name"]: self.metric(m["name"])
                          for m in self.metrics(cell_name, "per_layer")},
        }
