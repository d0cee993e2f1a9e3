#!/usr/bin/env python
"""Benchmark-trajectory smoke gate for the PyTorch port (the port's
counterpart of ``tools/bench_trajectory_smoke.py``).

    PYTHONPATH=src python tools/bench_trajectory_smoke_torch.py [--device cpu]

Runs ``repro_torch.benchmarks.trajectory`` at ``BENCH_SMOKE=1`` scale,
validates the ``lsmg-bench-trajectory-v1`` document (rows, both
amplification probe modes, percentiles), then drives
``tools/bench_compare.py`` both ways:
a self-compare of identical files must exit 0, and a synthetically
inflated copy (every row cost and amplification ratio x10) must exit
non-zero — proving the regression gate actually gates before any PR
relies on it.
"""
from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import sys
import tempfile
from pathlib import Path

# The reference gate's schema names, ``fail`` and ``run`` (it imports only
# the standard library); its checks sit inside its ``main``, so
# ``check_doc`` holds them here.
_spec = importlib.util.spec_from_file_location(
    "bench_trajectory_smoke_checks",
    Path(__file__).resolve().with_name("bench_trajectory_smoke.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)
SCHEMA, AMP_SCHEMA, fail, run = (base.SCHEMA, base.AMP_SCHEMA, base.fail,
                                 base.run)


def check_doc(doc: dict) -> None:
    """The schema checks of the trajectory document."""
    if doc.get("schema") != SCHEMA:
        fail(f"bad schema: {doc.get('schema')!r}")
    if not doc.get("suites"):
        fail("no suite rows")
    for key in ("scale", "suite_status", "amplification",
                "percentiles"):
        if key not in doc:
            fail(f"missing top-level key {key!r}")
    for mode in ("durable", "memory"):
        amp = doc["amplification"].get(mode)
        if not amp or amp.get("schema") != AMP_SCHEMA:
            fail(f"amplification[{mode}] missing or wrong schema")
        if amp["write"]["overall"] is None:
            fail(f"amplification[{mode}]: no write-amp measured")
    if doc["amplification"]["durable"]["mode"] != "physical":
        fail("durable probe did not use physical byte accounting")
    if not doc["percentiles"]:
        fail("no histogram percentiles captured")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the trajectory's device (default: the current "
                         "CUDA card; 'cpu' for the plain versions)")
    device = ap.parse_args(argv).device
    env = dict(os.environ)
    env.setdefault("PYTHONPATH", "src")
    env["BENCH_SMOKE"] = "1"
    with tempfile.TemporaryDirectory(prefix="bench_traj_") as td:
        traj = os.path.join(td, "traj.json")
        r = run([sys.executable, "-m", "repro_torch.benchmarks.trajectory",
                 "--pr", "0", "--out", traj]
                + ([] if device is None else ["--device", device]), env)
        if r.returncode != 0:
            fail(f"trajectory run exited {r.returncode}\n"
                 f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}")
        try:
            with open(traj) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            fail(f"trajectory file unreadable: {e}")
        check_doc(doc)

        cmp_py = os.path.join(os.path.dirname(__file__),
                              "bench_compare.py")
        r = run([sys.executable, cmp_py, traj, traj], env)
        if r.returncode != 0:
            fail(f"self-compare should pass, exited {r.returncode}\n"
                 f"{r.stdout}\n{r.stderr}")

        bad = copy.deepcopy(doc)
        for row in bad["suites"].values():
            row["us_per_call"] *= 10.0
        for mode in bad["amplification"].values():
            for sect in ("write", "read", "space"):
                if mode[sect]["overall"] is not None:
                    mode[sect]["overall"] *= 10.0
        inflated = os.path.join(td, "inflated.json")
        with open(inflated, "w") as f:
            json.dump(bad, f)
        r = run([sys.executable, cmp_py, traj, inflated], env)
        if r.returncode == 0:
            fail("inflated candidate passed the gate\n" + r.stdout)
        n = sum("REGRESSION" in ln for ln in r.stdout.splitlines())
        print(f"bench-trajectory-smoke: {len(doc['suites'])} rows, "
              f"{len(doc['percentiles'])} histograms validated; "
              f"self-compare passed, inflated copy failed with "
              f"{n} regressions flagged")
    print("bench-trajectory-smoke OK")


if __name__ == "__main__":
    main()
