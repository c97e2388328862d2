"""Finds what a cell needs by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, metric, work
count or driver is a file of its own, found by name under ``perfbench/``:

- ``configs/``: the configuration file that ``BENCHMARK.json`` names;
- ``traffic/<mix>.json``: a traffic mix (its ``driver`` names the code);
- ``drivers/<driver>.py``: set-up and one timed run of one kind of work;
- ``metrics/<metric>.py``: the reader of one metric;
- ``roofline/<role>.py``: the operations and bytes one kernel role needs.

So a later change adds a cell, a mix or a metric by adding files, and
edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from types import ModuleType

#: The checkout's root: the directory that holds ``BENCHMARK.json``.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what it refers to."""

    root: str
    bench: dict
    workload: dict
    config: dict
    traffic: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, group: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports:
        those that list it under ``workloads``, and those without the key."""
        return [m for m in self.bench[group]
                if self.name in m.get("workloads", [self.name])]

    def module(self, kind: str, name: str) -> ModuleType:
        return load_module(self.root, kind, name)


def read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises ``KeyError``
    for a name the file does not have."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    wl = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = read_json(os.path.join(root, cfg_entry["file"]))
    traffic = read_json(os.path.join(root, "perfbench", "traffic",
                                     wl["traffic"] + ".json"))
    return Cell(root=root, bench=bench, workload=wl, config=config,
                traffic=traffic)


def load_module(root: str, kind: str, name: str) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` under ``root`` as a module (a name
    may hold dots, so the file is loaded by its path)."""
    path = os.path.join(root, "perfbench", kind, name + ".py")
    key = f"perfbench._found.{kind}.{name}@{root}"
    if key in sys.modules:
        return sys.modules[key]
    if not os.path.exists(path):
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
