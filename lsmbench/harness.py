"""One run of one cell: set-up, the measured window, the check, the
metrics and the result line.

``run_cell`` is the whole run; ``main`` is the command line, which asks
for the CUDA card and refuses to run without one.  The tests call
``run_cell`` on the CPU at a small size.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import spec
from .data import make_stream
from .trace import Slice, SpanLog, summarize, warm_profiler

#: Top-level module names a run must not have loaded: JAX and the JAX
#: package of LSMGraph (``repro``; the port ``repro_torch`` is another
#: name).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

#: Kernel sources of the port that the graph store and its analytics use.
KERNEL_SOURCES = ("presence", "merge_perm", "segment_reduce", "lookup")


def _merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


class Run:
    """What one run knows: its cell, its data, the requests of its window
    and the readings the metric readers take."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float,
                 trace: bool, device: torch.device, log) -> None:
        self.cell, self.config, self.workload = (cell, cell.config,
                                                 cell.workload)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.cuda = device.type == "cuda"
        self.log = log
        self.spans = SpanLog(device)
        self.requests: List[tuple] = []   # (op, t0, t1, units, ok)
        self.errors: List[str] = []
        self.info: Dict[str, object] = {}
        self.t0, self.deadline = 0.0, float("inf")
        self.window_s = self.setup_s = 0.0
        self.obs_delta: Dict[str, tuple] = {}
        self.profile: Optional[dict] = None
        self._mu = threading.Lock()

    def record(self, op: str, t0: float, t1: float, units: int, ok: bool,
               err: Optional[BaseException] = None) -> None:
        with self._mu:
            self.requests.append((op, t0, t1, units, ok))
            if err is not None:
                self.errors.append(f"{op}: {type(err).__name__}: {err}")

    # --- what the readers read
    def done(self, op: str) -> List[tuple]:
        return [r for r in self.requests if r[0] == op and r[4]]

    def units(self, op: str) -> int:
        return sum(r[3] for r in self.done(op))

    def latencies(self, op: str) -> List[float]:
        return [r[2] - r[1] for r in self.done(op)]

    def obs_sum(self, name: str) -> float:
        """Seconds (or units) a program histogram gained in the window,
        over all its series."""
        return self.obs_delta.get(name, (0.0, 0))[0]

    def obs_count(self, name: str) -> int:
        return self.obs_delta.get(name, (0.0, 0))[1]


def _obs_totals() -> Dict[str, tuple]:
    from repro_torch import obs
    from repro_torch.obs.registry import Histogram
    out: Dict[str, list] = {}
    for inst in obs.REGISTRY.collect():
        if isinstance(inst, Histogram):
            acc = out.setdefault(inst.name, [0.0, 0])
            acc[0] += inst.sum
            acc[1] += inst.count
    return {k: tuple(v) for k, v in out.items()}


def _window(run: Run, op) -> None:
    """Start the clients together, profile a slice when tracing, and wait
    for each client's last request."""
    w = run.workload
    n = int(w["clients"])
    go = threading.Event()
    failures: List[BaseException] = []
    sl = None

    def body(i: int) -> None:
        go.wait()
        try:
            op.client(i, sl if i == 0 else None)
        except BaseException as e:   # re-raised in the main thread
            failures.append(e)

    threads = [threading.Thread(target=body, args=(i,), name=f"client{i}")
               for i in range(n)]
    for t in threads:
        t.start()
    before = _obs_totals()
    t0 = time.perf_counter()
    run.t0, run.deadline = t0, t0 + run.seconds
    if run.trace:
        length = min(float(w["trace_slice"]["seconds"]), run.seconds / 2)
        sl = Slice(run.deadline - length, run.cuda)
    run.spans = SpanLog(run.device)   # the window's spans alone
    go.set()
    for t in threads:
        t.join()
    if failures:
        raise failures[0]
    after = _obs_totals()
    run.obs_delta = {k: (v[0] - before.get(k, (0.0, 0))[0],
                         v[1] - before.get(k, (0.0, 0))[1])
                     for k, v in after.items()}
    ends = [r[2] for r in run.requests]
    run.window_s = (max(ends) if ends else time.perf_counter()) - t0
    run.slice = sl


def _device_info(run: Run) -> dict:
    if run.cuda:
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(run.device),
                "count": 1,
                "memory_peak_bytes": int(
                    torch.cuda.max_memory_allocated(run.device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def _log_window(run: Run, log) -> None:
    """What the window did, on standard error: its length, the requests'
    latencies, the units done in each 5 s and the program's spans."""
    log(f"window: {run.window_s:.3f} s, set-up {run.setup_s:.3f} s, "
        f"{len(run.requests)} requests")
    lat = sorted(r[2] - r[1] for r in run.requests if r[4])
    if lat:
        log("request ms: p50 {:.3f}, p90 {:.3f}, max {:.3f}".format(
            *(1e3 * lat[min(int(q * len(lat)), len(lat) - 1)]
              for q in (0.5, 0.9, 1.0))))
    marks = [0.0] * (int(run.window_s // 5) + 1)
    for r in run.requests:
        if r[4]:
            marks[min(int((r[2] - run.t0) // 5), len(marks) - 1)] += r[3]
    log("units done in each 5 s of the window: " + ", ".join(
        f"{m:.0f}" for m in marks))
    log("program spans in the window (s, count): " + ", ".join(
        f"{k} {v[0]:.3f} {v[1]}" for k, v in sorted(run.obs_delta.items())
        if v[1] and k.startswith(("store_", "read_"))))


def forbidden_modules() -> List[str]:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN_MODULES))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device, root: Path = spec.ROOT, overrides: Optional[dict] = None,
             t_start: Optional[float] = None, log=None) -> dict:
    """One run of cell ``name``: the result line as a dict.  ``overrides``
    is merged into the cell's configuration (``config``) and workload
    (``workload``), for runs at a small size."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    cell = spec.load_cell(name, root)
    if overrides:
        cell.config = _merge(cell.config, overrides.get("config", {}))
        cell.workload = _merge(cell.workload, overrides.get("workload", {}))
    run = Run(cell, seed, seconds, trace, device, log)
    op_mod = spec.load_op(cell.workload["op"], root / "lsmbench")
    if run.cuda:
        from repro_torch.kernels import _build
        took = _build.build_all(KERNEL_SOURCES)
        for src in KERNEL_SOURCES:
            _build.load(src)
        log(f"kernels: {', '.join(f'{k} {v:.1f} s' for k, v in took.items())}"
            f" (0.0: built before, in {_build.BUILD_DIR})")
    t = time.perf_counter()
    run.stream = make_stream(cell.config, seed, device)
    run.host = run.stream.host()
    log(f"data: {run.stream.n_records} records ({run.stream.n_inserts} "
        f"inserts, {run.stream.n_deletes} deletes, "
        f"{run.stream.picks_dropped} repeated delete picks dropped) in "
        f"{len(run.host.batches)} calls, made in "
        f"{time.perf_counter() - t:.3f} s")
    op = op_mod.Op(run)
    try:
        op.setup()
        if trace:
            warm_profiler(run.cuda)
        if run.cuda:
            torch.cuda.synchronize(device)
        gc.collect()
        t_window = time.perf_counter()
        run.setup_s = t_window - t_start
        _window(run, op)
        device_info = _device_info(run)
        run.profile = summarize(run.slice) if run.slice else None
        if run.slice is not None:
            log(f"trace: {run.slice.stop_s:.3f} s to stop the profiler, "
                f"after the window")
        run.slice = None
        t = time.perf_counter()
        checks = op.check()
        log(f"check: {time.perf_counter() - t:.3f} s")
    finally:
        op.close()
    attempted = len(run.requests)
    failed = sum(1 for r in run.requests if not r[4])
    for err in run.errors[:5]:
        log(f"failed request: {err}")
    correct = bool(attempted and failed == 0 and all(c.ok for c in checks))
    metrics = {}
    for m in cell.metrics:
        if m.end_to_end == trace:
            continue
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and run.profile is not None:
        p = run.profile
        device_info["busy_s"] = p["busy_s"]
        device_info["window_s"] = p["window_s"]
        result["breakdown"] = {
            "device_ops": [[k[:200], v] for k, v in p["device_ops"][:10]],
            "idle_gaps": [[k[:200], v] for k, v in p["idle_gaps"][:10]]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    _log_window(run, log)
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        print(f"lsmbench: cell {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0),
                      t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"lsmbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
