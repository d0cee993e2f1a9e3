#!/usr/bin/env python
"""Observability smoke gate for the PyTorch port (the port's counterpart of
``tools/obs_smoke.py``).

    PYTHONPATH=src python tools/obs_smoke_torch.py [--device cpu]

Runs ``python -m repro_torch.launch.graph_service --device ... --metrics
FILE`` at tiny scale — once single-store durable, once sharded durable —
and holds the per-phase metric reports to the checks of
``tools/obs_smoke.py``: the same schemas, phases and families, the closed
compaction decision enum and the presence-filter counters.  Those checks
are not copied: this script loads its own copy of that module (which
imports only the standard library) and calls its ``validate``; only the
service command differs.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "obs_smoke_checks", Path(__file__).resolve().with_name("obs_smoke.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)


def run_service(report_path: str, extra: list, device=None) -> None:
    cmd = [sys.executable, "-m", "repro_torch.launch.graph_service",
           "--vertices", "300", "--edges", "2000", "--queries", "64",
           "--metrics", report_path] + extra
    if device is not None:
        cmd += ["--device", device]
    env = dict(os.environ)
    env.setdefault("PYTHONPATH", "src")
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=900)
    if r.returncode != 0:
        base.fail(f"{' '.join(cmd)} exited {r.returncode}\n"
                  f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the service's device (default: the current CUDA "
                         "card; 'cpu' for the plain versions)")
    device = ap.parse_args(argv).device
    base_families = {"store", "storage", "io", "merge", "read"}
    with tempfile.TemporaryDirectory(prefix="obs_smoke_") as td:
        single = os.path.join(td, "single.json")
        run_service(single, ["--durable", os.path.join(td, "db_single")],
                    device)
        base.validate(single,
                      want_phases={"ingest", "analytics", "queries",
                                   "concurrent_reads", "restart_verify"},
                      want_families=base_families, tag="single-durable")

        sharded = os.path.join(td, "sharded.json")
        run_service(sharded, ["--durable", os.path.join(td, "db_shard"),
                              "--shards", "2", "--analytics", "2hop"],
                    device)
        base.validate(sharded,
                      want_phases={"ingest", "analytics", "queries",
                                   "restart_verify"},
                      want_families=base_families | {"shard", "compaction"},
                      tag="sharded-durable")
    print("obs-smoke OK")


if __name__ == "__main__":
    main()
