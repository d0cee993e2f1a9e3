"""The layout: every cell and metric of ``BENCHMARK.json`` resolves to
exactly one file of its own under ``lsmbench/``, and a new file is found
by its name with no other file edited.  Also the file's own limits."""
import json
import re
import shutil

import pytest

from lsmbench import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_and_metric_resolves_to_its_own_files():
    files = spec.resolve_all()
    assert files
    owned = {}
    for what, paths in files.items():
        for p in paths:
            assert p.is_file(), (what, p)
        if what.startswith(("metric:", "config:")):
            (p,) = paths
            assert p not in owned, (what, owned.get(p))
            owned[p] = what
    for w in BENCH["workloads"]:
        assert spec.workload_path(w["name"]) in files["cell:" + w["name"]]


def test_every_metric_a_cell_reports_is_read_by_its_reader():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        names = {m.name for m in cell.metrics}
        assert "setup_s" in names
        e2e = {m.name for m in cell.metrics if m.end_to_end}
        assert len(e2e) >= 2
        layer = [m for m in cell.metrics if not m.end_to_end]
        assert layer
        for m in BENCH["per_layer"]:
            if m["name"] in names:
                assert m["moves"] in e2e, (w["name"], m["name"])


def test_the_file_keeps_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lsmbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("lsmbench/")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert "roofline" not in m["name"] or m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


def _copy(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "lsmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_a_new_metric_file_is_found_by_name(tmp_path):
    bench = _copy(tmp_path)
    (tmp_path / "lsmbench" / "metrics" / "calls_total.ingest.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["per_layer"].append({
        "name": "calls_total.ingest", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "write path",
        "moves": "ingest_rate", "workloads": ["g500-s22.ingest"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("g500-s22.ingest", tmp_path)
    (m,) = [m for m in cell.metrics if m.name == "calls_total.ingest"]
    assert m.read(None) == 42.0
    other = spec.load_cell("g500-s22.analytics", tmp_path)
    assert "calls_total.ingest" not in {m.name for m in other.metrics}


def test_a_new_cell_is_found_by_name(tmp_path):
    bench = _copy(tmp_path)
    wl = json.loads((tmp_path / "lsmbench" / "workloads" /
                     "g500-s22.read-uniform.json").read_text())
    wl.update(traffic="read-small", vertices=256, clients=16)
    (tmp_path / "lsmbench" / "workloads" / "g500-s22.read-small.json"
     ).write_text(json.dumps(wl))
    bench["workloads"].append({"name": "g500-s22.read-small",
                               "config": "g500-s22", "traffic": "read-small",
                               "chips": 1, "why": "small reads"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("read_"):
            m["workloads"].append("g500-s22.read-small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("g500-s22.read-small", tmp_path)
    assert cell.workload["vertices"] == 256
    assert {"read_rate", "read_p95_ms", "setup_s"} <= {
        m.name for m in cell.metrics}
    assert spec.load_op(cell.workload["op"], tmp_path / "lsmbench").Op


def test_a_cell_whose_traffic_file_disagrees_is_refused(tmp_path):
    bench = _copy(tmp_path)
    bench["workloads"][0]["traffic"] = "something-else"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError):
        spec.load_cell(bench["workloads"][0]["name"], tmp_path)
