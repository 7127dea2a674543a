"""Finds a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix and each metric; everything that belongs to
one of them sits in files of its own under ``portbench/``:

  configs/<config>.json      the configuration as it is run (its ``builder``
                             names a module of ``graphs/``)
  traffic/<mix>.json         a traffic mix's parameters (its ``entry`` names
                             a module of ``entries/``, the request kind)
  workloads/<cell>.json      the cell's limits on the numbers ``correct``
                             compares
  metrics/<metric>.py        a metric's reader, ``read(run) -> value | None``

So a new cell, configuration, traffic mix or metric is new files and new
entries in ``BENCHMARK.json``; no file that is there changes."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import NamedTuple

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list     # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _file(root: Path, kind: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = root / "portbench" / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return path


def load_module(root: Path, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = _file(root, kind, name, ".py")
    key = f"portbench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def load_cell(root: Path, workload: str) -> Cell:
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    traffic = read_json(_file(root, "traffic", w["traffic"], ".json"))
    cell_file = root / "portbench" / "workloads" / f"{workload}.json"
    spec = read_json(cell_file) if cell_file.is_file() else {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, traffic, spec, e2e, layer)


__all__ = ["Cell", "NAME", "read_json", "load_module", "load_cell"]
