"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration, whose file the
``configs`` entry gives (``avsr_bench/configs/<name>.json``), and a traffic
mix, read from ``avsr_bench/traffic/<traffic>.json``, whose ``"driver"``
names the code that runs it, ``avsr_bench/drivers/<driver>.py``.  The
limits of the cell's correctness check are
``avsr_bench/limits/<workload>.json`` and each per-layer metric's reader is
``avsr_bench/metrics/<metric>.py``.  Everything is found by name, so a new
configuration, traffic mix, driver, limit or metric is a new file and an
entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    """One workload with everything it names, read from its files."""

    name: str
    chips: int
    config: dict       # the configuration file's object
    traffic: dict      # the traffic file's object (with its "name")
    limits: dict       # {number: limit} of the correctness check
    end_to_end: list   # the BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT, bench_dir: str = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, with its files read
    from ``bench_dir`` (default ``<root>/avsr_bench``).  Raises
    ``KeyError`` for a name the file does not hold."""
    bench_dir = bench_dir or os.path.join(root, "avsr_bench")
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = dict(_read_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")),
                   name=w["traffic"])
    limits = _read_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    if int(traffic.get("ranks", 1)) != int(w["chips"]):
        raise ValueError(f"{name}: traffic {w['traffic']} runs {traffic.get('ranks', 1)} "
                         f"ranks, the cell asks for {w['chips']} chips")
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def _load(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read(run)`` function of ``<bench_dir>/metrics/<name>.py``."""
    return _load(os.path.join(bench_dir, "metrics", f"{name}.py"),
                 f"avsr_bench_metric_{name}").read


_DRIVERS = {}


def driver(name: str, bench_dir: str = None):
    """The module ``<bench_dir>/drivers/<name>.py`` (default: this
    checkout's ``avsr_bench``), loaded once: its ``run`` and ``control``."""
    path = os.path.join(bench_dir or BENCH_DIR, "drivers", f"{name}.py")
    if path not in _DRIVERS:
        _DRIVERS[path] = _load(path, f"avsr_bench_driver_{name}")
    return _DRIVERS[path]
