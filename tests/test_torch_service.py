"""The port's graph service (``repro_torch.launch.graph_service``) against
the JAX package's ``repro.launch.graph_service``.

``powerlaw_edges`` (the service's stream) must give the reference's arrays
byte for byte.  The service runs with ``--device cpu``, once durable on a
single store (multi-level PageRank, a metrics report and a trace) and once
sharded, durable, with the chaos phase; the reference runs on the same
arguments.  Each run has a fresh interpreter of its own, so that each
package's process-wide metric registry holds only that run's series: in a
test worker, other files' stores and schedulers register theirs.  Their printed
deterministic lines (level sizes, top-5, reads found, per-shard edges and
taus, the chaos phase's masked and healed reads, the restored edge count)
must be equal, timings aside, and so must the family sets of each phase
of their metrics reports.  Sizes are small enough that no flush happens before the
service's own flush, so neither package's background threads can change
the layout.  Tolerance: none (integer output; PageRank's top-5 order).
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.graphgen import powerlaw_edges as ref_powerlaw  # noqa: E402
from repro_torch.data import powerlaw_edges  # noqa: E402
from repro_torch.launch import graph_service  # noqa: E402

REPORT_FAMILIES = {"store", "read", "storage", "io", "merge"}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while each test runs (restored after): the
    tensors here are small, and the suite runs several workers on one
    machine, where every worker's spinning OpenMP threads would
    oversubscribe the cores and slow the tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_vertices,n_edges,seed,unique", [
    (2000, 30000, 0, True), (500, 4000, 3, True), (97, 1000, 11, False),
    (1, 10, 0, False)])
def test_powerlaw_edges_byte_equal_reference(n_vertices, n_edges, seed,
                                             unique):
    got = powerlaw_edges(n_vertices, n_edges, seed=seed, unique=unique)
    want = ref_powerlaw(n_vertices, n_edges, seed=seed, unique=unique)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# Lines whose numbers are deterministic, and the part of each to compare.
_SINGLE = [r"levels=\[[^\]]*\]", r"top: .*", r"\d+ non-empty"]
_SHARDED = [r"edges/shard=\[[^\]]*\]", r"epoch=\d+ taus=\(.*\)",
            r"2hop in [\d.]+s; (top: .*)",
            r"sharded batched reads: \d+ vertices .* (\d+ non-empty)",
            r"chaos: flipped one bit in .*",
            r"— (\d+ masked \(shards .*\), \d+ healthy non-empty)",
            r"chaos:   shard \d+ \[\d+,\d+\] \w+",
            r"chaos: write to fenced shard rejected .*",
            r"edge set (restored — byte-for-byte equivalent); "
            r"(health=.*)",
            r"recovered (\d+) edges in [\d.]+s after restart: (\w+)"]


def _pick(text, patterns):
    out = []
    for pat in patterns:
        hits = [m.groups() or (m.group(0),)
                for m in re.finditer(pat, text)]
        assert hits, f"no line matches {pat!r} in:\n{text}"
        out.append(hits)
    return out


def _service(package, argv):
    """``package``'s graph service on ``argv`` in a fresh interpreter (one
    torch intra-op thread); its standard output."""
    code = ("import sys\n"
            + ("import torch\ntorch.set_num_threads(1)\n"
               if package == "repro_torch" else "")
            + f"from {package}.launch import graph_service\n"
            f"sys.argv = ['graph_service'] + {argv!r}\n"
            "graph_service.main()\n")
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=root,
                       env=dict(os.environ, PYTHONPATH=str(root / "src"),
                                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def _run_port(argv):
    return _service("repro_torch", argv + ["--device", "cpu"])


def _run_reference(argv):
    return _service("repro", argv)


def _families(path):
    doc = json.loads(open(path).read())
    assert doc["schema"] == graph_service.REPORT_SCHEMA == \
        "lsmg-metrics-report-v1"
    return {ph: set(snap["families"]) for ph, snap in doc["phases"].items()}


def test_service_single_store_matches_reference(tmp_path):
    """A durable single store with merge-free multi-level PageRank, a
    metrics report and a trace: the same levels, top-5, reads and restart
    verdict as the reference, and the same report families."""
    argv = ["--vertices", "500", "--edges", "1500", "--analytics",
            "pagerank-multilevel", "--queries", "100"]
    got = _run_port(argv + ["--durable", str(tmp_path / "p"),
                            "--metrics", str(tmp_path / "m.json"),
                            "--trace", str(tmp_path / "t.json")])
    want = _run_reference(argv + ["--durable", str(tmp_path / "r"),
                                  "--metrics", str(tmp_path / "r.json")])
    picks = _SINGLE + [r"after restart: (\w+)"]
    assert _pick(got, picks) == _pick(want, picks)
    assert "after restart: OK" in got
    fams = _families(tmp_path / "m.json")
    assert fams == _families(tmp_path / "r.json")
    assert set(fams) == {"ingest", "analytics", "queries",
                         "concurrent_reads", "restart_verify"}
    assert REPORT_FAMILIES <= fams["restart_verify"]
    trace = json.loads((tmp_path / "t.json").read_text())
    assert any(e["ph"] == "X" for e in trace["traceEvents"])


def test_service_sharded_durable_chaos_matches_reference(tmp_path):
    argv = ["--vertices", "500", "--edges", "2000", "--analytics", "2hop",
            "--queries", "100", "--shards", "2", "--chaos"]
    got = _run_port(argv + ["--durable", str(tmp_path / "p"),
                            "--metrics", str(tmp_path / "m.json")])
    want = _run_reference(argv + ["--durable", str(tmp_path / "r"),
                                  "--metrics", str(tmp_path / "r.json")])
    assert "edge set restored" in got
    assert _pick(got, _SHARDED) == _pick(want, _SHARDED)
    fams = _families(tmp_path / "m.json")
    assert fams == _families(tmp_path / "r.json")
    assert set(fams) == {"ingest", "analytics", "queries", "chaos",
                         "restart_verify"}
    assert REPORT_FAMILIES | {"shard", "compaction"} <= fams["chaos"]


def test_service_needs_a_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph_service.main(["--vertices", "50", "--edges", "100"])


def test_service_chaos_needs_shards_and_durable(capsys):
    with pytest.raises(SystemExit):
        graph_service.main(["--chaos", "--device", "cpu"])
    assert "--chaos requires" in capsys.readouterr().err


def test_obs_smoke_tool_on_the_port():
    """``tools/obs_smoke_torch.py`` runs the port's service twice with
    ``--device cpu`` and holds both metrics reports to the checks of
    ``tools/obs_smoke.py``, which it loads rather than copies."""
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, str(root / "tools" /
                                            "obs_smoke_torch.py"),
                        "--device", "cpu"], capture_output=True, text=True,
                       timeout=300, cwd=root,
                       env=dict(os.environ, PYTHONPATH=str(root / "src"),
                                OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "obs-smoke [single-durable]" in r.stdout
    assert "obs-smoke [sharded-durable]" in r.stdout
    assert r.stdout.rstrip().endswith("obs-smoke OK")
