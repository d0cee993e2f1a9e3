"""Persisted benchmark trajectory: every suite + amplification, one file
(the port of ``benchmarks/trajectory.py``).

``python -m repro_torch.benchmarks.trajectory --pr N [--device cpu]``
runs every registered suite from ``repro_torch.benchmarks.run.suites()``
at a pinned scale, runs a deterministic amplification probe (one durable +
one in-memory store through ingest → flush → compact → batched reads), and
merges the CSV rows, both ``lsmg-amp-v1`` reports, and every populated
histogram's percentiles of the port's ``obs.REGISTRY`` into a single
``BENCH_TORCH_PR<N>.json`` (never the reference's ``BENCH_PR<N>.json``).
``tools/bench_compare.py`` diffs two of them and fails on regression past
configurable thresholds.

Schema (``lsmg-bench-trajectory-v1``, the reference's, plus ``device``)::

    {"schema": "lsmg-bench-trajectory-v1", "pr": N,
     "device": {"type": "cuda" | "cpu", "name": "..."},
     "scale": {"V":..., "E":..., "smoke": bool, "scale": int},
     "suites": {"<row name>": {"us_per_call": f, "derived": "..."}},
     "suite_status": [{"suite":..., "ok":..., "rows":..., "seconds":...}],
     "amplification": {"durable": <lsmg-amp-v1>, "memory": <lsmg-amp-v1>},
     "percentiles": {"<name>{labels}": {"count":..., "p50":..., "p99":...}}}

``BENCH_SMOKE=1`` shrinks it to the CI gate scale (numbers meaningless;
schema and exit status are the contract — ``tools/
bench_trajectory_smoke_torch.py``).  Row names are the harness's
``name,us_per_call,derived`` names, unique across suites by contract; a
collision gets a ``#k`` suffix rather than silently overwriting.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import sys
import tempfile
import time
import traceback

SCHEMA = "lsmg-bench-trajectory-v1"

_ROW = re.compile(r"^(?P<name>[\w./\-]+),(?P<us>-?[\d.eE+\-]+),"
                  r"(?P<derived>.*)$")


def _run_suites(device) -> tuple:
    """Run every registered suite, capturing rows.  Returns
    (rows: {name: {us_per_call, derived}}, status: [per-suite entries],
    failures: int)."""
    from .run import suites
    rows: dict = {}
    status = []
    failures = 0
    for label, fn in suites():
        entry = {"suite": label, "ok": True, "rows": 0, "seconds": 0.0}
        buf = io.StringIO()
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(buf):
                fn(device)
        except Exception:
            entry["ok"] = False
            entry["error"] = traceback.format_exc(limit=4)
            failures += 1
        entry["seconds"] = round(time.time() - t0, 2)
        n = 0
        for line in buf.getvalue().splitlines():
            line = line.strip()
            if not line:
                continue
            m = _ROW.match(line)
            if not m:
                entry.setdefault("bad_rows", []).append(line)
                continue
            us = float(m.group("us"))
            if not math.isfinite(us):
                entry.setdefault("bad_rows", []).append(line)
                continue
            name = m.group("name")
            if name in rows:                       # collision: keep both
                k = 2
                while f"{name}#{k}" in rows:
                    k += 1
                name = f"{name}#{k}"
            rows[name] = {"us_per_call": us, "derived": m.group("derived")}
            n += 1
        entry["rows"] = n
        if entry["ok"] and (n == 0 or entry.get("bad_rows")):
            entry["ok"] = False
            failures += 1
        status.append(entry)
        print(f"# trajectory: {label}: {n} rows in "
              f"{entry['seconds']}s{'' if entry['ok'] else ' (FAILED)'}",
              file=sys.stderr)
    return rows, status, failures


def _amp_probe(device) -> dict:
    """Deterministic amplification scenario: the SAME mixed workload
    against a durable store (physical-byte ledger) and an in-memory one
    (logical-movement ledger), so trajectory files compare amplification
    like-for-like across PRs.

    Sources are EVEN vertex ids only, and the read phase queries both
    parities: the even half measures the productive read path, the odd
    (vertex-absent) half is the paper's "invalid random read" shape the
    presence filters exist for — runs-per-query counts only runs with
    post-filter visible pairs, and the durable mode's evicted scalar
    sweep of absent vertices must reload (`read.cold_load_bytes`) nothing."""
    import numpy as np

    from .. import obs
    from ..core import LSMGraph
    from ..storage import open_store
    from .common import scale, store_cfg, suite_device

    dev = suite_device(device)
    n_batches, batch = (4, 512) if scale().smoke else (12, 2048)
    out = {}
    for mode in ("durable", "memory"):
        with tempfile.TemporaryDirectory(prefix="amp_probe_") as td:
            if mode == "durable":
                g = open_store(os.path.join(td, "db"), store_cfg(),
                               device=dev, wal_sync="batch")
            else:
                g = LSMGraph(store_cfg(), device=dev)
            rng = np.random.default_rng(7)
            v = store_cfg().vmax
            for i in range(n_batches):
                s = (rng.integers(0, v, batch) & ~1).astype(np.int64)
                d = rng.integers(0, v, batch).astype(np.int64)
                g.insert_edges(s, d)
                if i % 3 == 2:
                    g.flush_memgraph()
            g.flush_memgraph()
            g.compact_l0()
            # One more flushed batch AFTER the compaction: an L0 run (no
            # per-vertex index entries, only fid gates) rides above L1 for
            # the read phase — the run shape presence filters exist for.
            s = (rng.integers(0, v, batch) & ~1).astype(np.int64)
            d = rng.integers(0, v, batch).astype(np.int64)
            g.insert_edges(s, d)
            g.flush_memgraph()
            with g.snapshot() as snap:
                snap.neighbors_batch(np.arange(0, v, 2, dtype=np.int64))
                snap.neighbors_batch(np.arange(1, v, 2, dtype=np.int64))
            if mode == "durable":
                # Evicted-store sweep of filter-rejected vertices: the
                # cold_load_bytes this store reports is exactly the
                # reload traffic the filters failed to prevent.
                g.durability.evict_all_segments()
                with g.snapshot() as snap:
                    for q in range(1, min(v, 257), 2):
                        snap.neighbors_scalar(q)
            led = obs.AmplificationLedger(g)
            out[mode] = led.report(exact_space=True)
            g.close()
    return out


def _percentiles() -> dict:
    """Every populated histogram's count/p50/p99 of the port's registry —
    the latency side of the trajectory (resolve, flush, compaction, WAL
    fsync...)."""
    from .. import obs
    out = {}
    for inst in obs.REGISTRY.collect():
        if not isinstance(inst, obs.Histogram):
            continue
        snap = inst.snapshot()
        if not snap["count"]:
            continue
        lab = ",".join(f"{k}={v}" for k, v in sorted(inst.labels.items()))
        key = inst.name + (f"{{{lab}}}" if lab else "")
        out[key] = {"count": snap["count"],
                    "p50": snap["p50"], "p99": snap["p99"]}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pr", type=int, required=True,
                    help="PR ordinal: output defaults to "
                         "BENCH_TORCH_PR<N>.json")
    ap.add_argument("--out", default=None, metavar="FILE")
    ap.add_argument("--device", default=None,
                    help="device of the port's stores (default: the "
                         "current CUDA card; 'cpu' for the plain versions)")
    args = ap.parse_args(argv)
    out_path = args.out or f"BENCH_TORCH_PR{args.pr}.json"

    import torch

    from .common import scale, suite_device
    dev = suite_device(args.device)
    sc = scale()
    t0 = time.time()
    rows, status, failures = _run_suites(dev)
    amp = _amp_probe(dev)
    doc = {
        "schema": SCHEMA,
        "pr": args.pr,
        "device": {"type": dev.type,
                   "name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")},
        "scale": {"V": sc.V, "E": sc.E, "smoke": sc.smoke,
                  "scale": sc.scale},
        "suites": rows,
        "suite_status": status,
        "amplification": amp,
        "percentiles": _percentiles(),
    }
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, out_path)
    print(f"# trajectory: {len(rows)} rows, "
          f"{len(doc['percentiles'])} histograms, "
          f"{failures} failed suites -> {out_path} "
          f"in {time.time()-t0:.0f}s", file=sys.stderr)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
