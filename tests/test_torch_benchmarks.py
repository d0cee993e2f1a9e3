"""The port's benchmark harness (``repro_torch.benchmarks``) against the JAX
package's (``benchmarks``), at smoke scale on the CPU.

Every suite of ``repro_torch.benchmarks.run.suites()`` runs once with
``--device cpu`` (the plain versions of the kernels) and every suite of the
reference's ``benchmarks.run.suites()`` once, both at ``BENCH_SMOKE=1``.
Each port suite must pass the smoke gate's row schema; its row names must
equal the reference's, ``kernel_*_pallas`` -> ``kernel_*_kernel`` being the
one rename; and every field of ``derived`` that counts rather than times
(bytes moved, bytes on disk, cached records, runs probed per query,
SSSP runs, recovered edges and vertices, kernel sizes, the sharded oracle
verdict) must equal the reference's.  The port's trajectory runs at smoke
scale through the checks of ``tools/bench_trajectory_smoke_torch.py`` and
through ``tools/bench_compare.py`` (``--schema-only`` against the
reference's committed ``BENCH_PR10.json``; the tool's own self-compare and
x10-inflated compare).  Tolerance: none (integers and their fixed-point
prints).
"""
import ast
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

# The reference reads BENCH_SMOKE when its common module is imported.
_prev = os.environ.get("BENCH_SMOKE")
os.environ["BENCH_SMOKE"] = "1"
try:
    from benchmarks import common as ref_common  # noqa: E402
    from benchmarks import run as ref_run  # noqa: E402
finally:
    if _prev is None:
        os.environ.pop("BENCH_SMOKE")
    else:
        os.environ["BENCH_SMOKE"] = _prev
from repro_torch.benchmarks import common, smoke, trajectory  # noqa: E402
from repro_torch.benchmarks import run as port_run  # noqa: E402

LABELS = [label for label, _ in port_run.suites()]

# Fields of ``derived`` that count (bytes, records, runs, verdicts): equal
# to the reference's.  Keys are row-name prefixes.
COUNTED = {
    "fig11_": ("write_bytes",),
    "fig12_": ("io_bytes",),
    "fig14_": ("bytes",),
    "fig15_scan_": ("cached",),
    "fig16_": ("io_bytes",),
    "fig17_": ("io_bytes",),
    "fig18_mixed_sssp": ("n_runs",),
    "read_under_ingest_idle_p50": ("readers",),
    "bench_filters_": ("rpq", "cold_kb"),
    "durability/ingest_off": ("disk",),
    "durability/ingest_batch": ("disk",),
    "durability/ingest_always": ("disk",),
    "durability/recover_": ("edges", "vertices"),
    "kernel_segsum_": ("E",),
    "kernel_attn_": ("flops",),
    "sharded_oracle_concurrent": ("identical",),
}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while each test runs (restored after): the
    suite runs several workers on one machine, where every worker's
    spinning OpenMP threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _derived(text):
    return dict(kv.split("=", 1) for kv in text.split(";") if "=" in kv)


def _rows(lines):
    out = {}
    for line in lines:
        name, us, derived = line.split(",", 2)
        out[name] = (float(us), derived)
    return out


@pytest.fixture(scope="module")
def port_report():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {e["suite"]: e for e in smoke.run_suites("cpu")["suites"]}
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_rows():
    assert ref_common.SMOKE
    out = {}
    for label, fn in ref_run.suites():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
        out[label] = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    return out


def test_suite_registry_matches_reference():
    assert LABELS == [label for label, _ in ref_run.suites()]
    assert len(LABELS) == 11


@pytest.mark.parametrize("label", LABELS)
def test_port_suite_passes_smoke_gate(port_report, label):
    entry = port_report[label]
    assert entry["ok"], entry.get("error")
    assert entry["rows"] > 0
    assert smoke._check_rows(entry["lines"]) == []


@pytest.mark.parametrize("label", LABELS)
def test_row_names_equal_reference(port_report, ref_rows, label):
    got = [ln.split(",", 1)[0] for ln in port_report[label]["lines"]]
    want = [ln.split(",", 1)[0].replace("_pallas", "_kernel")
            for ln in ref_rows[label]]
    assert got == want


@pytest.mark.parametrize("label", LABELS)
def test_counting_fields_equal_reference(port_report, ref_rows, label):
    got = _rows(port_report[label]["lines"])
    want = {k.replace("_pallas", "_kernel"): v
            for k, v in _rows(ref_rows[label]).items()}
    compared = 0
    for name, (_, derived) in want.items():
        for prefix, fields in COUNTED.items():
            if not name.startswith(prefix):
                continue
            a, b = _derived(got[name][1]), _derived(derived)
            for f in fields:
                assert a[f] == b[f], (name, f, a[f], b[f])
                compared += 1
    if label != "batched reads":     # its rows carry rates only
        assert compared > 0, label


def test_kernel_rows_name_the_route(port_report):
    rows = _rows(port_report["kernels"]["lines"])
    for name in ("kernel_segsum_kernel", "kernel_attn_kernel"):
        assert _derived(rows[name][1])["route"] == "plain"


def test_kernel_route_follows_the_launch_count(monkeypatch):
    """``route=`` names what the wrapper ran, read from its launch count:
    a wrapper that counts a launch (here the plain version standing in for
    the kernel) gives ``cuda``; one that does not gives ``plain``."""
    from repro_torch.benchmarks import bench_kernels
    from repro_torch.kernels import _build, ops

    def counted_segsum(dst, seg, wt, x, *, n_out, use_pallas=True):
        _build.count_launch(ops.KERNELS["gather_segsum"])
        return bench_kernels.gather_segsum_ref(dst, seg, wt, x, n_out)

    monkeypatch.setattr(bench_kernels.ops, "gather_segsum", counted_segsum)
    with common.use_scale(common.Scale(smoke=True)):
        rows = {name: derived for name, _, derived in
                bench_kernels.run("cpu")}
    assert _derived(rows["kernel_segsum_kernel"])["route"] == "cuda"
    assert _derived(rows["kernel_attn_kernel"])["route"] == "plain"


def test_sharded_oracle_is_independent_of_the_stores():
    """The sharded suite's numpy oracle: each query's ascending distinct
    out-neighbours, equal to a port store's reads of the same insert-only
    stream and unequal once an edge is dropped."""
    from repro_torch.benchmarks import bench_sharded
    from repro_torch.core import LSMGraph
    with common.use_scale(common.Scale(smoke=True)):
        z = bench_sharded._sizes()
        src, dst = bench_sharded._stream(z, seed=23)
        src, dst = src[:3000], dst[:3000]
        store = LSMGraph(bench_sharded._cfg(z), device="cpu")
        store.insert_edges(src, dst)
    qs = np.r_[src[:200], np.random.default_rng(0).integers(0, z.V, 200)]
    with store.snapshot() as snap:
        got = snap.neighbors_batch(qs)
    want = bench_sharded._numpy_neighbors(src, dst, qs)
    brute = [np.array(sorted({int(d) for s, d in zip(src, dst) if s == q}))
             for q in qs]
    assert bench_sharded._same(want, got)
    assert all(np.array_equal(a, b) for a, b in zip(want, brute))
    assert not bench_sharded._same(
        bench_sharded._numpy_neighbors(src[1:], dst[1:], qs[:1]), got[:1])


def test_scale_is_read_when_a_suite_runs(monkeypatch):
    monkeypatch.setenv("BENCH_SMOKE", "1")
    monkeypatch.setenv("BENCH_SCALE", "large")
    assert common.scale() == common.Scale(smoke=True, scale=10)
    with common.use_scale(common.Scale()):
        assert (common.scale().V, common.scale().E) == (2000, 30000)
        with common.use_scale(common.Scale(scale=10)):
            assert common.scale().E == 300000
    monkeypatch.delenv("BENCH_SMOKE")
    monkeypatch.delenv("BENCH_SCALE")
    assert (common.scale().V, common.scale().E) == (2000, 30000)


def test_smoke_cli_exits_zero():
    r = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.smoke",
                        "--device", "cpu"], capture_output=True, text=True,
                       timeout=300, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    report = json.loads(r.stdout)
    assert report["failures"] == 0 and len(report["suites"]) == 11


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trajectory_schema_and_schema_only_compare(tmp_path):
    out = tmp_path / "traj.json"
    with common.use_scale(common.Scale(smoke=True)), \
            contextlib.redirect_stderr(io.StringIO()):
        with pytest.raises(SystemExit) as e:
            trajectory.main(["--pr", "20", "--out", str(out),
                             "--device", "cpu"])
    assert e.value.code == 0
    doc = json.loads(out.read_text())
    _load_tool("bench_trajectory_smoke_torch").check_doc(doc)
    assert doc["device"] == {"type": "cpu", "name": "cpu"}
    assert doc["scale"] == {"V": 500, "E": 6000, "smoke": True, "scale": 1}
    assert all(s["ok"] for s in doc["suite_status"])
    assert any(k.startswith("read_resolve_seconds") for k in
               doc["percentiles"])
    r = subprocess.run([sys.executable, str(ROOT / "tools" /
                                            "bench_compare.py"),
                        "--schema-only", str(ROOT / "BENCH_PR10.json"),
                        str(out)], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[schema-only]" in r.stdout
    retired = re.search(r"retired rows: (\[.*\])", r.stdout)
    # Only the renamed kernel rows and the rows of the larger scale retire.
    for name in (ast.literal_eval(retired.group(1)) if retired else []):
        assert name.endswith("_pallas") or re.search(
            r"_10000$|depth[48]|_[48]$", name), name


def test_trajectory_smoke_tool():
    """The tool runs the trajectory in a subprocess at smoke scale, checks
    its schema, and drives ``bench_compare.py`` both ways."""
    r = subprocess.run([sys.executable, str(ROOT / "tools" /
                                            "bench_trajectory_smoke_torch.py"),
                        "--device", "cpu"], capture_output=True, text=True,
                       timeout=300, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "self-compare passed, inflated copy failed" in r.stdout
    assert "bench-trajectory-smoke OK" in r.stdout
