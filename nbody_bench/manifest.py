"""Find every piece of a cell by its name.

``BENCHMARK.json`` at the root of the checkout names the cells, their
configuration and traffic, and the metrics. Each piece is a file of its
own under this package, found by that name alone:

* ``configs/<config>.json`` — a configuration;
* ``traffic/<traffic>.json`` — a traffic mix, whose ``loop`` names
* ``loops/<loop>.py`` — the kind of client loop;
* ``workloads/<cell>.json`` — the cell's correctness sample and limits;
* ``metrics/<metric>.py`` — one metric's reader, ``read(ctx)``; a
  quantity split by a suffix (``device_idle_pct.p3m``, ``.bh``) is read
  by the file of its stem (``metrics/device_idle_pct.py``) unless the
  full name has a file of its own.

Adding a cell, a configuration or a metric is adding files and entries:
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _file(kind: str, name: str, ext: str, pkg: Path) -> Path:
    path = pkg / kind / f"{name}{ext}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def load_module(path: Path):
    """Import the Python file ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        "nbody_bench._by_name." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything one cell runs: its entry in ``BENCHMARK.json``, its
    configuration, traffic, loop module, workload file and the metrics it
    reports with ``--trace 0`` (``end_to_end``) and ``--trace 1``
    (``per_layer``)."""

    def __init__(self, name: str, bench: dict | None = None,
                 pkg: Path = PKG):
        bench = bench if bench is not None else benchmark(pkg.parent)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                           f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config = load_json(_file("configs", self.entry["config"],
                                      ".json", pkg))
        self.traffic = load_json(_file("traffic", self.entry["traffic"],
                                       ".json", pkg))
        self.loop = load_module(_file("loops", self.traffic["loop"], ".py",
                                      pkg))
        self.workload = load_json(_file("workloads", name, ".json", pkg))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
        self._pkg = pkg

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``metrics/<metric>.py``, else of
        ``metrics/<stem>.py``, the stem the name before its first dot."""
        stem = metric.split(".", 1)[0]
        if stem != metric and not (self._pkg / "metrics"
                                   / f"{metric}.py").is_file():
            metric = stem
        return load_module(_file("metrics", metric, ".py", self._pkg)).read
