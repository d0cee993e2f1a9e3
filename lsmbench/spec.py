"""Where the benchmark finds each of its parts, by the names that
``BENCHMARK.json`` gives them.

- a configuration: the ``file`` of its entry in ``configs``;
- a cell's traffic: ``lsmbench/workloads/<cell>.json``, whose ``op`` names
  the client loop in ``lsmbench/ops/<op>.py``;
- a metric, end-to-end or per-layer: its reader
  ``lsmbench/metrics/<metric>.py``, a function ``read(run)`` that returns
  the metric's value, or None where the run has nothing to read.

A later change adds a configuration, a cell or a metric as new files and
new entries, and edits no file that is here.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Metric:
    name: str
    unit: str
    end_to_end: bool
    read: Callable


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    metrics: List[Metric]     # every metric this cell reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload_path(cell: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "workloads" / f"{cell}.json"


def metric_path(metric: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "metrics" / f"{metric}.py"


def op_path(op: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "ops" / f"{op}.py"


def load_reader(path: Path) -> Callable:
    mod_name = "lsmbench_metric_" + path.stem.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_op(op: str, bench_dir: Path = BENCH_DIR):
    """The module of a client loop, ``<bench_dir>/ops/<op>.py``, loaded as
    ``lsmbench.ops.<op>``."""
    importlib.import_module("lsmbench.ops")
    spec = importlib.util.spec_from_file_location(
        f"lsmbench.ops.{op}", op_path(op, bench_dir))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its parts."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    bench_dir = root / "lsmbench"
    workload = load_json(workload_path(name, bench_dir))
    if workload.get("traffic") != cell["traffic"]:
        raise ValueError(f"{workload_path(name, bench_dir)} is traffic "
                         f"{workload.get('traffic')!r}, BENCHMARK.json says "
                         f"{cell['traffic']!r}")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    metrics = []
    for entry, is_e2e in ([(m, True) for m in e2e]
                          + [(m, False) for m in bench["per_layer"]]):
        if not is_e2e and name not in entry["workloads"]:
            continue
        metrics.append(Metric(
            name=entry["name"], unit=entry["unit"], end_to_end=is_e2e,
            read=load_reader(metric_path(entry["name"], bench_dir))))
    return Cell(name=name, chips=int(cell["chips"]), config=config,
                workload=workload, metrics=metrics)


def resolve_all(root: Path = ROOT) -> Dict[str, List[Path]]:
    """Every file each cell and metric of ``BENCHMARK.json`` resolves to:
    the layout check's view."""
    bench = load_json(root / "BENCHMARK.json")
    bench_dir = root / "lsmbench"
    out: Dict[str, List[Path]] = {}
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        out["config:" + c["name"]] = [root / c["file"]]
    for w in bench["workloads"]:
        wl = load_json(workload_path(w["name"], bench_dir))
        out["cell:" + w["name"]] = [workload_path(w["name"], bench_dir),
                                    root / configs[w["config"]]["file"],
                                    op_path(wl["op"], bench_dir)]
    for m in bench["end_to_end"] + bench["per_layer"]:
        out["metric:" + m["name"]] = [metric_path(m["name"], bench_dir)]
    return out
