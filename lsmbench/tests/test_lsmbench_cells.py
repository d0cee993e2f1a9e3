"""A small CPU run of each cell ends in the result line with ``correct``
true; the same run with the timed path broken underneath ends with
``correct`` false, once for each fault the cell can have.  The look for a
card is the command line's, which these runs skip (``run_cell``)."""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from lsmbench_helpers import CELLS, run_small

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_small_run_is_correct_and_keeps_the_result_keys(cell):
    r = run_small(cell)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert "breakdown" not in r
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert "setup_s" in r["metrics"]
    assert len(r["metrics"]) >= 2
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(cell):
    r = run_small(cell, trace=True)
    assert r["correct"] is True
    assert "setup_s" not in r["metrics"] and r["metrics"]
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(r["breakdown"]["idle_gaps"]) <= 10
    assert list(r)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_small_run_on_the_card(cell, cuda_device):
    r = run_small(cell, device=cuda_device, trace=True)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0


def _state_unchanged(mp, cell):
    from repro_torch.core import LSMGraph
    if cell.endswith("analytics"):
        import repro_torch.analytics as an
        from repro_torch.analytics import algorithms
        real = algorithms.pagerank
        mp.setattr(an, "pagerank",
                   lambda view, iters=20, **kw: real(view, iters=0, **kw))
    elif cell.endswith("read-uniform"):
        from repro_torch.core.store import Snapshot

        def nothing(self, vs, return_props=False):
            e = (np.zeros(0, np.int64), np.zeros(0, np.float32))
            return [e for _ in np.asarray(vs).ravel()]
        mp.setattr(Snapshot, "neighbors_batch", nothing)
    else:
        real = LSMGraph._apply

        def apply(self, src, dst, prop, *, delete, allow_flush=True):
            if _IN_WINDOW[0]:
                return None
            return real(self, src, dst, prop, delete=delete,
                        allow_flush=allow_flush)
        mp.setattr(LSMGraph, "_apply", apply)


def _half_batch(mp, cell):
    from repro_torch.core import LSMGraph
    if cell.endswith("analytics"):
        import repro_torch.analytics as an
        from repro_torch.analytics import view as view_mod
        real = view_mod.materialize_csr

        def half(snap, n):
            v = real(snap, n)
            keep = v.n_edges // 2
            return v._replace(voff=v.voff.clamp(max=keep), dst=v.dst[:keep],
                              prop=v.prop[:keep], n_edges=keep)
        mp.setattr(an, "materialize_csr", half)
    elif cell.endswith("read-uniform"):
        from repro_torch.core.store import Snapshot
        real = Snapshot.neighbors_batch

        def half(self, vs, return_props=False):
            vs = np.asarray(vs)
            out = real(self, vs[: len(vs) // 2], return_props)
            e = (np.zeros(0, np.int64), np.zeros(0, np.float32))
            return out + [e] * (len(vs) - len(vs) // 2)
        mp.setattr(Snapshot, "neighbors_batch", half)
    else:
        real = LSMGraph._apply

        def apply(self, src, dst, prop, *, delete, allow_flush=True):
            if _IN_WINDOW[0]:
                k = len(src) // 2
                src, dst = src[:k], dst[:k]
                prop = None if prop is None else prop[:k]
            return real(self, src, dst, prop, delete=delete,
                        allow_flush=allow_flush)
        mp.setattr(LSMGraph, "_apply", apply)


def _answer_altered(mp, cell):
    from repro_torch.core import LSMGraph
    if cell.endswith("analytics"):
        import repro_torch.analytics as an
        from repro_torch.analytics import algorithms
        real = algorithms.sssp

        def sssp(view, source, **kw):
            d = real(view, source, **kw)
            d[source] += 1e-2
            return d
        mp.setattr(an, "sssp", sssp)
    elif cell.endswith("read-uniform"):
        from repro_torch.core.store import Snapshot
        real = Snapshot.neighbors_batch

        def altered(self, vs, return_props=False):
            out = real(self, vs, return_props)
            for i, (d, p) in enumerate(out):
                if len(d):
                    p = p.copy()
                    p[0] += 1.0
                    out[i] = (d, p)
                    break
            return out
        mp.setattr(Snapshot, "neighbors_batch", altered)
    else:
        real = LSMGraph._apply

        def apply(self, src, dst, prop, *, delete, allow_flush=True):
            if _IN_WINDOW[0] and prop is not None and len(prop):
                prop = np.array(prop, np.float32)
                prop[0] += 1.0
            return real(self, src, dst, prop, delete=delete,
                        allow_flush=allow_flush)
        mp.setattr(LSMGraph, "_apply", apply)


#: Whether the run is in its window (faults planted in the write path
#: leave the set-up's warm-up alone, so that the run reaches its check).
_IN_WINDOW = [False]

FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}
CASES = [(c, f) for c in CELLS for f in FAULTS]


@pytest.mark.parametrize("cell,fault", CASES)
def test_planted_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    from lsmbench import harness
    real_window = harness._window

    def window(run, op):
        _IN_WINDOW[0] = True
        try:
            real_window(run, op)
        finally:
            _IN_WINDOW[0] = False
    monkeypatch.setattr(harness, "_window", window)
    FAULTS[fault](monkeypatch, cell)
    r = run_small(cell)
    assert r["correct"] is False, (fault, r["checks"])
    assert r["attempted"] > 0


@pytest.mark.parametrize("fault", [None] + list(FAULTS))
def test_ingest_checks_the_pass_that_took_the_whole_stream(fault,
                                                           monkeypatch):
    # The window ends one call after the stream's first restart, so the
    # current pass holds a single call and the whole stream is in the
    # deployment kept from the first pass: a fault planted in that pass
    # alone has to make the run incorrect, and without one it is correct.
    from lsmbench import harness
    real_window = harness._window
    restarts = []

    def window(run, op):
        real_deploy = op._deploy

        def deploy():
            restarts.append(time.perf_counter())
            _IN_WINDOW[0] = False
            run.deadline = time.perf_counter()
            return real_deploy()
        op._deploy = deploy
        _IN_WINDOW[0] = True
        try:
            real_window(run, op)
        finally:
            _IN_WINDOW[0] = False
    monkeypatch.setattr(harness, "_window", window)
    if fault is not None:
        FAULTS[fault](monkeypatch, "g500-s22.ingest")
    log = []
    from lsmbench import spec
    from lsmbench.harness import run_cell
    from lsmbench_helpers import SEED, SMALL
    r = run_cell("g500-s22.ingest", SEED, 600.0, False, "cpu",
                 root=spec.ROOT, overrides=SMALL, log=log.append)
    assert len(restarts) == 1
    passes = [m for m in log if m.startswith("check: pass")]
    assert len(passes) == 2, log
    assert r["correct"] is (fault is None), (fault, r["checks"], passes)


def test_command_line_refuses_without_a_card(tmp_path):
    # Without CUDA, and in a checkout that holds only BENCHMARK.json and
    # the benchmark's files: another exit code than 0 and no result line.
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(root, "lsmbench"), tmp_path / "lsmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (root, str(tmp_path)):
        p = subprocess.run(
            [sys.executable, "lsmbench/run.py", "--workload",
             "g500-s22.ingest", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=where, capture_output=True, text=True,
            timeout=120)
        assert p.returncode != 0
        assert "correct" not in p.stdout
