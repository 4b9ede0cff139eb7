"""Find the benchmark's pieces by name.

A ``Catalog`` searches its roots in order, each a directory that holds
``BENCHMARK.json`` or a ``portbench/`` tree (or both); the first file found
wins. The repository's root is the last root, so a test can put a
throwaway configuration, mix, metric or limit in a temporary folder ahead
of it without editing a file here.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional, Sequence

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with what it refers to, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]  # the entries this cell reports with --trace 0
    per_layer: List[dict]  # the entries this cell reports with --trace 1
    limits: dict


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Catalog:
    def __init__(self, roots: Sequence[str] = ()):
        self.roots = [*roots, REPO_ROOT]
        self._modules: Dict[str, ModuleType] = {}

    def find(self, rel: str) -> str:
        """The first ``<root>/<rel>`` that exists."""
        for root in self.roots:
            path = os.path.join(root, rel)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(f"{rel} is in none of {self.roots}")

    def _json(self, rel: str) -> dict:
        with open(self.find(rel)) as f:
            return json.load(f)

    def benchmark(self) -> dict:
        return self._json("BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration's file, as ``BENCHMARK.json`` names it."""
        entry = next((c for c in self.benchmark()["configs"]
                      if c["name"] == name), None)
        if entry is None:
            raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
        return self._json(entry["file"])

    def traffic(self, name: str) -> dict:
        return self._json(os.path.join("portbench", "traffic", name + ".json"))

    def limits(self, cell: str) -> dict:
        return self._json(os.path.join("portbench", "limits", cell + ".json"))

    def _module(self, kind: str, name: str) -> ModuleType:
        key = f"{kind}/{name}"
        if key not in self._modules:
            path = self.find(os.path.join("portbench", kind, name + ".py"))
            mod_name = "portbench_" + key.replace("/", "_").replace(
                ".", "_").replace("-", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def driver(self, loop: str) -> ModuleType:
        """``drivers/<loop>.py``: runs one loop kind."""
        return self._module("drivers", loop)

    def reader(self, metric: str) -> ModuleType:
        """``metrics/<metric>.py``: its ``read(run)`` gives the value or
        None (nothing to read)."""
        return self._module("metrics", metric)

    def cell(self, name: str) -> Cell:
        bench = self.benchmark()
        entry: Optional[dict] = next(
            (w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        traffic = self.traffic(entry["traffic"])
        limits = self.limits(name)
        loop = traffic["loop"]
        if "late_pct" in limits and not self.driver(loop).RECORDS_LATENCY:
            raise ValueError(
                f"{name}: its limits name late_pct, but its loop {loop!r} "
                "records no per-block latencies")
        return Cell(
            name=name, chips=int(entry["chips"]),
            config=self.config(entry["config"]), traffic=traffic,
            end_to_end=[m for m in bench["end_to_end"]
                        if _reported_in(m, name)],
            per_layer=[m for m in bench["per_layer"] if _reported_in(m, name)],
            limits=limits)
