"""Finds a cell's files by name under the benchmark's root.

- ``workloads/<cell>.json``: ``config``, ``traffic``, ``chips`` and the
  ``limits`` of the numbers its check compares;
- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic's parameters (``traffic``);
- ``entries/<config>.py``: builds and calls the program's entry;
- ``references/<config>.py``: the plain reference and its comparison;
- ``metrics/<metric>.py``: the reader of one metric.

A file is found by its name alone, so a cell, a configuration or a metric
is added as new files and no file that is there changes.
"""
from __future__ import annotations

import collections
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent

Cell = collections.namedtuple(
    "Cell", "name root config traffic chips limits entry reference")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def module(root, kind: str, name: str):
    """``<root>/<kind>/<name>.py``, loaded by its path."""
    path = Path(root) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"_dspbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(root, kind: str, suffix: str) -> list:
    """The names of every ``<root>/<kind>/*<suffix>`` file, sorted."""
    return sorted(p.name[:-len(suffix)]
                  for p in (Path(root) / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def load(name: str, root=ROOT) -> Cell:
    root = Path(root)
    path = root / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(
            f"no workload {name!r} ({path}); known: "
            f"{', '.join(names(root, 'workloads', '.json'))}")
    w = _json(path)
    return Cell(name, str(root), _json(root / "configs" /
                                       f"{w['config']}.json"),
                _json(root / "traffic" / f"{w['traffic']}.json"),
                int(w["chips"]), dict(w["limits"]),
                module(root, "entries", w["config"]),
                module(root, "references", w["config"]))


def metrics(root=ROOT) -> dict:
    """Every metric reader under ``<root>/metrics``, by name."""
    return {n: module(root, "metrics", n)
            for n in names(root, "metrics", ".py")}
