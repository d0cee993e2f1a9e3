"""The port's observability layer against the JAX package's.

Ports of the reference's ``tests/test_obs.py`` (registry primitives under
threads, histogram accuracy, the disabled-path cost, the exporters'
schemas, spans and the trace ring, the store's metric families, the
``IOCounters`` mirror, the ``MERGE_STATS`` view, the concurrent wrapper's
error capture) and ``tests/test_amplification.py`` (the amplification
ledger in memory and durable, dead series, span outcomes, Prometheus
escaping, the Chrome trace, the read accounting's cost, the reporter's
refresh hooks), on the port's ``repro_torch.obs``.  The ledger's report
and the exported series of one store must equal the reference's on the
same stream, timings aside: integer fields byte-equal, ratios within
1e-6 relative.  The reference's ``bench_compare`` case tests a tool the
port does not have and is not ported.
"""
import dataclasses
import json
import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import small_store_cfg  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import storage as jstorage  # noqa: E402
from repro.core import LSMGraph as JLSMGraph  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402
from repro_torch.obs import (AMP_SCHEMA, SCHEMA, Reporter,  # noqa: E402
                             export_json, export_prometheus)
from repro_torch.obs.amplification import (LOGICAL_EDGE_BYTES,  # noqa: E402
                                           AmplificationLedger)
from repro_torch.obs.registry import Histogram, MetricRegistry  # noqa: E402
from repro_torch.obs.trace_export import (export_chrome_trace,  # noqa: E402
                                          to_chrome_trace)
from repro_torch.storage import open_store  # noqa: E402

#: Series the port adds beyond the reference's: the spine build's span,
#: the step spans of the apply, the compaction, the run seal, the
#: resolve and the view build, and the view build's source count.
PORT_ONLY = {("read", "spine_build_seconds"),
             ("store", "apply_upload_seconds"),
             ("store", "apply_wait_seconds"),
             ("store", "compaction_merge_seconds"),
             ("store", "run_seal_seconds"),
             ("read", "resolve_sealed_seconds"),
             ("read", "resolve_mem_seconds"),
             ("read", "resolve_host_seconds"),
             ("analytics", "view_collect_seconds"),
             ("analytics", "view_merge_seconds"),
             ("analytics", "view_sources_total")}


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


def pcfg(**kw):
    return StoreConfig(**dataclasses.asdict(small_store_cfg(**kw)))


def _ingest(g, n_batches=6, batch=512, seed=0, v=1 << 10):
    rng = np.random.default_rng(seed)
    total = 0
    for _ in range(n_batches):
        src = rng.integers(0, v, batch).astype(np.int64)
        dst = rng.integers(0, v, batch).astype(np.int64)
        g.insert_edges(src, dst)
        total += batch
    return total


# ----------------------------------------------------------- registry core
def test_counter_concurrent_exact():
    reg = MetricRegistry()
    c = reg.counter("t_hits_total", worker="w")
    n_threads, per = 8, 10_000

    def work():
        for _ in range(per):
            c.inc()

    ts = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.value == n_threads * per
    c.inc(42)
    assert c.value == n_threads * per + 42


def test_histogram_concurrent_observe_exact():
    reg = MetricRegistry()
    h = reg.histogram("t_latency_seconds")
    n_threads, per = 8, 5_000

    def work(seed):
        rng = np.random.default_rng(seed)
        for x in rng.uniform(1e-5, 1e-2, per):
            h.observe(float(x))

    ts = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    snap = h.snapshot()
    assert snap["count"] == n_threads * per
    assert 0 < snap["min"] <= snap["p50"] <= snap["p99"] <= snap["max"]


def test_gauge_set_inc_dec():
    reg = MetricRegistry()
    g = reg.gauge("t_depth", level="0")
    g.set(5)
    assert g.value == 5
    g.inc(2)
    g.dec()
    assert g.value == 6


def test_registry_identity_and_kind_mismatch():
    reg = MetricRegistry()
    a = reg.counter("t_x_total", shard="0")
    assert reg.counter("t_x_total", shard="0") is a
    assert reg.counter("t_x_total", shard="1") is not a
    with pytest.raises(TypeError):
        reg.gauge("t_x_total", shard="0")


def test_registry_remove_and_find():
    reg = MetricRegistry()
    reg.gauge("x_depth", store="a", level="0").set(3)
    reg.gauge("x_depth", store="a", level="1").set(5)
    reg.gauge("x_depth", store="b", level="0").set(7)
    assert len(reg.find("x_depth")) == 3
    assert len(reg.find("x_depth", store="a")) == 2
    assert reg.remove("x_depth", store="a", level="0") is True
    assert reg.remove("x_depth", store="a", level="0") is False  # gone
    assert {i.value for i in reg.find("x_depth")} == {5, 7}
    assert reg.gauge("x_depth", store="a", level="0").value == 0


def test_histogram_percentiles_vs_numpy_and_reference():
    """Log-bucket estimates land within one bucket ratio of numpy's exact
    percentiles, and equal the reference registry's on the same values."""
    rng = np.random.default_rng(11)
    xs = rng.lognormal(mean=-6.0, sigma=1.2, size=50_000)
    h = MetricRegistry().histogram("t_acc_seconds")
    ref = jobs.MetricRegistry().histogram("t_acc_seconds")
    for x in xs:
        h.observe(float(x))
        ref.observe(float(x))
    ratio = 10.0 ** (1.0 / 20.0)
    for p in (50.0, 99.0, 99.9):
        true = float(np.percentile(xs, p))
        est = h.percentile(p)
        assert true / ratio <= est <= true * ratio, (p, true, est)
        assert est == ref.percentile(p)
    snap = h.snapshot()
    assert snap == ref.snapshot()
    assert snap["count"] == len(xs)
    assert snap["min"] == pytest.approx(xs.min())
    assert snap["max"] == pytest.approx(xs.max())
    assert snap["sum"] == pytest.approx(xs.sum(), rel=1e-6)


def test_histogram_empty_and_clamping():
    reg = MetricRegistry()
    h = reg.histogram("t_edge_seconds", lo=1e-3, hi=1e0)
    assert h.percentile(50) == 0.0
    assert h.snapshot()["count"] == 0
    h.observe(1e-9)
    h.observe(50.0)
    snap = h.snapshot()
    assert snap["count"] == 2
    assert snap["min"] == pytest.approx(1e-9)
    assert snap["max"] == pytest.approx(50.0)
    assert snap["min"] <= h.percentile(50) <= snap["max"]


# ------------------------------------------------------------------ spans
def test_span_observes_duration_histogram():
    reg = MetricRegistry()
    with reg.span("t_op", store="s0") as sp:
        time.sleep(0.01)
    assert sp.duration >= 0.01
    snap = reg.histogram("t_op_seconds", store="s0").snapshot()
    assert snap["count"] == 1
    assert snap["min"] >= 0.01


def test_span_nesting_depth_and_labels_in_trace_ring():
    reg = MetricRegistry()
    assert reg.trace_events() == []  # tracing off by default
    reg.enable_tracing(capacity=16)
    with reg.span("t_outer", store="s0"):
        with reg.span("t_inner", store="s0", level="1"):
            pass
    events = reg.trace_events()
    assert [e["name"] for e in events] == ["t_inner", "t_outer"]
    by_name = {e["name"]: e for e in events}
    assert by_name["t_outer"]["depth"] == 0
    assert by_name["t_inner"]["depth"] == 1
    assert by_name["t_inner"]["labels"] == {"store": "s0", "level": "1"}
    assert all(e["dur"] >= 0 and e["thread"] for e in events)
    reg.disable_tracing()
    with reg.span("t_after"):
        pass
    assert reg.trace_events() == []


def test_trace_ring_bounded():
    reg = MetricRegistry()
    reg.enable_tracing(capacity=4)
    for i in range(10):
        with reg.span("t_ring", i=str(i)):
            pass
    events = reg.trace_events()
    assert len(events) == 4
    assert [e["labels"]["i"] for e in events] == ["6", "7", "8", "9"]


def test_span_exception_records_outcome_and_counter():
    reg = MetricRegistry()
    reg.enable_tracing(capacity=16)
    with pytest.raises(ValueError):
        with reg.span("store_flush", store="s0"):
            raise ValueError("boom")
    ev = reg.trace_events()[-1]
    assert ev["name"] == "store_flush" and ev["ok"] is False
    assert reg.counter("store_flush_errors_total", store="s0").value == 1
    with reg.span("store_flush", store="s0"):
        pass
    assert reg.trace_events()[-1]["ok"] is True
    assert reg.counter("store_flush_errors_total", store="s0").value == 1
    assert reg.histogram("store_flush_seconds",
                         store="s0").snapshot()["count"] == 2


def test_disabled_path_overhead():
    """The no-exporter/no-tracing hot path stays near-free: bound the
    per-op cost of a counter increment and of an empty span."""
    reg = MetricRegistry()
    c = reg.counter("t_ov_total")
    n = 20_000

    def best_of(runs, fn):
        best = float("inf")
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    def counters():
        for _ in range(n):
            c.inc()

    def spans():
        for _ in range(n):
            with reg.span("t_ov"):
                pass

    per_inc = best_of(3, counters) / n
    per_span = best_of(3, spans) / n
    assert per_inc < 20e-6, f"counter.inc cost {per_inc*1e6:.2f}us"
    assert per_span < 60e-6, f"span cost {per_span*1e6:.2f}us"
    assert reg.trace_events() == []


# -------------------------------------------------------------- exporters
def _sample_registry(mod=None):
    reg = (mod or obs).MetricRegistry()
    reg.counter("store_ops_total", store="s0").inc(7)
    reg.gauge("store_l0_depth", store="s0").set(3)
    h = reg.histogram("read_resolve_seconds")
    for x in (1e-4, 2e-4, 5e-3):
        h.observe(x)
    return reg


def test_export_json_schema_roundtrip():
    reg = _sample_registry()
    doc = json.loads(json.dumps(export_json(reg)))  # must be JSON-clean
    assert doc["schema"] == SCHEMA == jobs.SCHEMA
    assert doc == jobs.export_json(_sample_registry(jobs))
    assert set(doc["families"]) == {"store", "read"}
    store_fam = doc["families"]["store"]
    (ops_entry,) = store_fam["ops_total"]
    assert ops_entry["type"] == "counter"
    assert ops_entry["value"] == 7
    assert ops_entry["labels"] == {"store": "s0"}
    (depth_entry,) = store_fam["l0_depth"]
    assert depth_entry["type"] == "gauge" and depth_entry["value"] == 3
    (hist_entry,) = doc["families"]["read"]["resolve_seconds"]
    assert hist_entry["type"] == "histogram"
    assert hist_entry["count"] == 3
    for k in ("sum", "min", "max", "p50", "p99", "p999"):
        assert k in hist_entry


def test_export_prometheus_text():
    text = export_prometheus(_sample_registry())
    assert text == jobs.export_prometheus(_sample_registry(jobs))
    assert "# TYPE store_ops_total counter" in text
    assert 'store_ops_total{store="s0"} 7' in text
    assert "# TYPE store_l0_depth gauge" in text
    assert "read_resolve_seconds_count 3" in text
    assert 'read_resolve_seconds{quantile="0.99"}' in text
    for line in text.splitlines():
        if line and not line.startswith("#"):
            assert len(line.rsplit(" ", 1)) == 2


def test_prometheus_escapes_hostile_labels_roundtrip():
    hostile = 'pa\\th "quoted"\nnewline'
    help_text = {"io_err_total": 'errors \\ by "path"\nline2'}
    texts = []
    for mod in (obs, jobs):
        reg = mod.MetricRegistry()
        reg.counter("io_err_total", path=hostile).inc(3)
        texts.append(mod.export_prometheus(reg, help_text=help_text))
    text = texts[0]
    assert text == texts[1]
    lines = text.strip().splitlines()
    assert len(lines) == 3
    help_line, type_line, metric = lines
    assert help_line == \
        '# HELP io_err_total errors \\\\ by "path"\\nline2'
    assert type_line == "# TYPE io_err_total counter"
    m = re.match(r'io_err_total\{path="(.*)"\} 3$', metric)
    assert m, metric
    unescaped = (m.group(1).replace("\\n", "\n").replace('\\"', '"')
                 .replace("\\\\", "\\"))
    assert unescaped == hostile


def test_reporter_thread_periodic_and_final():
    reg = _sample_registry()
    got = []
    rep = Reporter(reg, interval=0.05, sink=got.append).start()
    time.sleep(0.2)
    rep.stop()
    assert len(got) >= 2  # at least one periodic + the final report
    assert all(d["schema"] == SCHEMA for d in got)
    assert not rep._thread.is_alive()


def test_reporter_refresh_hooks_run_and_drop_on_error():
    reg = MetricRegistry()
    calls = {"ok": 0, "bad": 0}

    def ok():
        calls["ok"] += 1

    def bad():
        calls["bad"] += 1
        raise RuntimeError("refresh broke")

    docs = []
    rep = Reporter(reg, interval=999.0, sink=docs.append,
                   refresh=[ok, bad])
    rep._export()
    rep._export()
    assert calls["ok"] == 2
    assert calls["bad"] == 1          # dropped after the first failure
    rep.start()
    rep.stop()                        # final export still runs hooks
    assert calls["ok"] == 3
    assert len(docs) == 1


# ----------------------------------------------------------- trace export
def _traced(mod):
    reg = mod.MetricRegistry()
    reg.enable_tracing(capacity=64)
    with reg.span("store_flush", store="s0"):
        with reg.span("storage_wal_fsync"):
            time.sleep(0.001)
    reg.trace_instant("store_flush_commit", store="s0", fid="3")
    with pytest.raises(RuntimeError):
        with reg.span("store_compaction", level="1"):
            raise RuntimeError("x")
    return reg


def test_chrome_trace_export(tmp_path):
    reg = _traced(obs)
    doc = to_chrome_trace(reg)
    evs = doc["traceEvents"]
    assert any(e["ph"] == "M" and e["name"] == "thread_name" for e in evs)
    durs = [e for e in evs if e["ph"] == "X"]
    inst = [e for e in evs if e["ph"] == "i"]
    assert {e["name"] for e in durs} == {
        "store_flush", "storage_wal_fsync", "store_compaction"}
    assert inst[0]["name"] == "store_flush_commit"
    assert inst[0]["args"]["fid"] == "3"
    for e in durs + inst:
        assert isinstance(e["ts"], int) and e["ts"] >= 0
        assert e["cat"] in ("store", "storage")
    fsync = next(e for e in durs if e["name"] == "storage_wal_fsync")
    assert fsync["dur"] >= 1000                       # slept 1 ms
    bad = next(e for e in durs if e["name"] == "store_compaction")
    assert bad["args"]["ok"] is False
    # The reference's document has the same events, fields and kinds.
    ref = jobs.to_chrome_trace(_traced(jobs))["traceEvents"]

    def shape(events):
        return [(e["ph"], e["name"], e.get("cat"), sorted(e["args"]))
                for e in events]
    assert shape(evs) == shape(ref)
    out = tmp_path / "trace.json"
    n = export_chrome_trace(str(out), reg)
    assert n == 4
    assert json.loads(out.read_text())["traceEvents"]


def test_trace_export_empty_ring():
    reg = MetricRegistry()             # tracing disabled
    assert to_chrome_trace(reg) == {"traceEvents": [],
                                    "displayTimeUnit": "ms"}


# ------------------------------------------------- store integration views
def test_iocounters_mirror_durable_manifest_bytes(tmp_path):
    """A durable store's IOCounters mirror into labeled registry counters,
    the manifest_write funnel included."""
    g = open_store(str(tmp_path / "db"), pcfg(), device="cpu",
                   wal_sync="off")
    src = np.arange(512, dtype=np.int32)
    dst = (src * 7 + 1) % 512
    g.insert_edges(src, dst)
    g.flush_memgraph()
    io = g.io
    assert io.manifest_write > 0
    assert io.wal_write > 0 and io.segment_write > 0
    label = g.obs_label
    for field in ("manifest_write", "wal_write", "segment_write"):
        c = obs.REGISTRY.counter(f"io_{field}_bytes", store=label)
        assert c.value == getattr(io, field), field
    copy = dataclasses.replace(io)
    before = obs.REGISTRY.counter("io_wal_write_bytes", store=label).value
    copy.wal_write += 999
    assert obs.REGISTRY.counter(
        "io_wal_write_bytes", store=label).value == before
    g.close()


def test_merge_stats_registry_view():
    """MERGE_STATS is a view over monotonic ``merge_<key>_total`` registry
    counters (the port keeps the reference's counters, not its mapping
    and reset surface)."""
    from repro_torch.kernels.merge import MERGE_STATS

    base = obs.REGISTRY.counter("merge_kernel_merge_total").value
    assert MERGE_STATS.snapshot_stats()["kernel_merge"] == base
    MERGE_STATS.bump("kernel_merge")
    MERGE_STATS.bump("kernel_merge")
    assert obs.REGISTRY.counter(
        "merge_kernel_merge_total").value == base + 2
    assert MERGE_STATS.snapshot_stats()["kernel_merge"] == base + 2


def _store_series(mod, label):
    """One store's exported series: (family, key, type, labels but the
    store) -> counter/gauge value, or a histogram's count (timings
    aside)."""
    out = {}
    for fam, keys in mod.export_json(mod.REGISTRY)["families"].items():
        for key, ents in keys.items():
            for e in ents:
                if e["labels"].get("store") != label:
                    continue
                lab = tuple(sorted((k, v) for k, v in e["labels"].items()
                                   if k != "store"))
                out[(fam, key, e["type"], lab)] = e.get("value",
                                                        e.get("count"))
    return out


def _workload(g):
    _ingest(g, n_batches=4, batch=600, seed=5)
    g.delete_edges(np.arange(100), np.arange(100) + 1)
    g.flush_memgraph()
    g.compact_l0()
    _ingest(g, n_batches=1, batch=300, seed=6)
    with g.snapshot() as snap:
        snap.neighbors_batch(np.arange(64, dtype=np.int64))
        snap.neighbors_batch([3])


def test_store_emits_per_layer_families():
    """A store exercising apply/flush/compact/read paths populates the
    store/io/merge/read families, and every series of the store equals the
    JAX package's on the same stream (histograms by count)."""
    g = LSMGraph(pcfg(), device="cpu")
    ref = JLSMGraph(small_store_cfg())
    _workload(g)
    _workload(ref)
    fams = export_json(obs.REGISTRY)["families"]
    for fam in ("store", "io", "merge", "read"):
        assert fam in fams, fam
    assert obs.REGISTRY.counter(
        "store_state_publish_total", store=g.obs_label).value > 0
    got = _store_series(obs, g.obs_label)
    want = _store_series(jobs, ref.obs_label)
    assert {k[0] for k in got} == {k[0] for k in want}
    extra = {k[:2] for k in set(got) - set(want)}
    assert extra <= PORT_ONLY, extra
    assert {k: got.get(k) for k in want} == want
    g.close()
    ref.close()


def test_concurrent_background_error_surfaced():
    """A background-thread failure is captured structurally (work item,
    repr, traceback), bumps the error counter, and surfaces through the
    _check raise chain."""
    from repro_torch.core.concurrent import ConcurrentLSMGraph

    g = ConcurrentLSMGraph(pcfg(), device="cpu")
    before = obs.REGISTRY.counter(
        "store_background_errors_total", thread="writer").value
    g.store._apply_no_flush = None  # type: ignore[assignment]
    g._q.put(("insert", np.array([1]), np.array([2]), None))
    for _ in range(500):
        if g._error is not None:
            break
        time.sleep(0.01)
    assert g._error is not None
    with pytest.raises(RuntimeError, match="background thread failed"):
        g._check()
    err = g.last_errors["writer"]
    assert "insert batch of 1" == err["work"]
    assert "TypeError" in err["error"] or "TypeError" in err["traceback"]
    assert obs.REGISTRY.counter(
        "store_background_errors_total", thread="writer").value == before + 1


# ---------------------------------------------------------------- ledger
def test_logical_edge_bytes_pins_core_constants():
    from repro_torch.core.types import BYTES_PER_EDGE, BYTES_PER_PROP

    assert LOGICAL_EDGE_BYTES == BYTES_PER_EDGE + BYTES_PER_PROP
    assert LOGICAL_EDGE_BYTES == jobs.amplification.LOGICAL_EDGE_BYTES
    assert AMP_SCHEMA == jobs.AMP_SCHEMA


def _same_report(got, want, skip=("cold_load_bytes_process",)):
    """Integer fields byte-equal, float ratios within 1e-6 relative."""
    assert type(got) is type(want), (got, want)
    if isinstance(want, dict):
        keys = set(want) - set(skip)
        assert set(got) - set(skip) == keys
        for k in keys:
            _same_report(got[k], want[k], skip)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-6)
    else:
        assert got == want


def test_ledger_report_equals_reference_in_memory():
    g = LSMGraph(pcfg(), device="cpu")
    ref = JLSMGraph(small_store_cfg())
    for s in (g, ref):
        _workload(s)
    got = AmplificationLedger(g).report(exact_space=True)
    want = jobs.AmplificationLedger(ref).report(exact_space=True)
    assert got["mode"] == "logical"
    got.pop("store")
    want.pop("store")
    _same_report(got, want)
    _same_report(AmplificationLedger(g).ratios(),
                 jobs.AmplificationLedger(ref).ratios())
    g.close()
    ref.close()


def test_ledger_reconciles_durable_io_exact(tmp_path):
    """Durable ingest + flush + compact: the ledger's physical-byte parts
    equal the IOCounters fields, the level series sum to the segment
    bytes, disk accounting is consistent, and the whole report equals the
    JAX package's on the same stream."""
    g = open_store(str(tmp_path / "db"), pcfg(), device="cpu",
                   wal_sync="off")
    ref = jstorage.open_store(str(tmp_path / "ref"), small_store_cfg(),
                              wal_sync="off")
    for s in (g, ref):
        n = _ingest(s)
        s.flush_memgraph()
        s.compact_l0()
    led = AmplificationLedger(g)
    rep = led.report(exact_space=True)
    assert rep["schema"] == AMP_SCHEMA
    assert rep["mode"] == "physical"
    w = rep["write"]
    assert w["physical_bytes"]["wal"] == g.io.wal_write
    assert w["physical_bytes"]["segment"] == g.io.segment_write
    assert w["physical_bytes"]["manifest"] == g.io.manifest_write
    assert w["physical_bytes"]["total"] == (
        g.io.wal_write + g.io.segment_write + g.io.manifest_write)
    assert w["logical_ingest_bytes"] == n * LOGICAL_EDGE_BYTES
    assert w["overall"] == pytest.approx(
        w["physical_bytes"]["total"] / (n * LOGICAL_EDGE_BYTES))
    assert sum(e["bytes"] for e in w["per_level"].values()) == \
        g.io.segment_write
    assert rep["space"]["disk_bytes"] == g.disk_bytes()
    assert rep["space"]["estimate"] is False
    assert rep["space"]["overall"] > 0
    want = jobs.AmplificationLedger(ref).report(exact_space=True)
    rep.pop("store")
    want.pop("store")
    _same_report(rep, want)
    before = obs.REGISTRY.counter(
        "io_wal_write_bytes", store=g.obs_label).value
    copy = dataclasses.replace(g.io)
    copy.wal_write += 12345
    assert obs.REGISTRY.counter(
        "io_wal_write_bytes", store=g.obs_label).value == before
    assert led.write_amplification()["physical_bytes"]["wal"] == before
    g.close()
    ref.close()


def test_read_amplification_counters():
    """Batched reads feed queries/probes/returned; touched >= returned and
    runs-per-query reflects the batch-amortized source count."""
    g = LSMGraph(pcfg(), device="cpu")
    _ingest(g, n_batches=4)
    g.flush_memgraph()
    led = AmplificationLedger(g)
    base = led.read_amplification()
    with g.snapshot() as snap:
        snap.neighbors_batch(np.arange(256, dtype=np.int64))
    r = led.read_amplification()
    assert r["queries"] - base["queries"] >= 256
    assert r["runs_probed"] > base["runs_probed"]
    assert r["bytes_returned"] > base["bytes_returned"]
    assert r["bytes_touched"] >= r["bytes_returned"]
    assert r["overall"] >= 1.0
    assert r["runs_per_query"] > 0
    g.close()


def test_space_estimate_upper_bounds_exact():
    g = LSMGraph(pcfg(), device="cpu")
    src = np.arange(256, dtype=np.int64) % 64
    dst = (src * 3 + 1) % 64
    g.insert_edges(src, dst)
    g.insert_edges(src, dst)  # duplicates: estimate counts them twice
    g.flush_memgraph()
    led = AmplificationLedger(g)
    est = led.live_edge_bytes()
    exact = led.live_edge_bytes(exact=True)
    assert est["estimate"] is True and exact["estimate"] is False
    assert est["bytes"] >= exact["bytes"] > 0
    g.close()


def test_empty_store_ratios_are_null_and_gauges_absent():
    g = LSMGraph(pcfg(), device="cpu")
    led = AmplificationLedger(g)
    rep = led.report()
    assert rep["write"]["overall"] is None
    assert rep["read"]["overall"] is None
    led.refresh_gauges()
    assert not obs.REGISTRY.find("amp_write_ratio", store=g.obs_label)
    assert not obs.REGISTRY.find("amp_read_ratio", store=g.obs_label)
    g.close()


def test_refresh_gauges_sets_ratio_series():
    g = LSMGraph(pcfg(), device="cpu")
    _ingest(g, n_batches=3)
    g.flush_memgraph()
    with g.snapshot() as snap:
        snap.neighbors_batch(np.arange(64, dtype=np.int64))
    AmplificationLedger(g).refresh_gauges()
    w = obs.REGISTRY.find("amp_write_ratio", store=g.obs_label)
    assert any(i.labels.get("level") is None for i in w)   # overall
    assert any(i.labels.get("level") == "0" for i in w)    # per-level
    assert obs.REGISTRY.find("amp_read_ratio", store=g.obs_label)
    assert obs.REGISTRY.find("amp_space_ratio", store=g.obs_label)
    g.close()


def test_shard_health_report_carries_amplification():
    """Every shard's health entry carries its ledger's ratios, equal to the
    JAX package's sharded store's on the same stream."""
    from repro import shard as jshard
    from repro_torch.shard import ShardedGraphStore

    g = ShardedGraphStore(pcfg(), 2, device="cpu")
    ref = jshard.ShardedGraphStore(small_store_cfg(), 2)
    src = (np.arange(512, dtype=np.int64) * 8) % (1 << 12)
    for s in (g, ref):
        s.insert_edges(src, (src * 7 + 1) % (1 << 12))
        s.flush_all()
        s.sharded_neighbors_batch(np.arange(64, dtype=np.int64))
    rep = g.health_report()
    want = ref.health_report()
    assert set(rep) == {0, 1}
    for s, entry in rep.items():
        amp = entry["amplification"]
        assert set(amp) == {"write", "read", "space", "runs_per_query"}
        assert amp["write"] is not None and amp["write"] > 0
        assert entry["status"] == want[s]["status"] == "ok"
        assert entry["range"] == want[s]["range"]
        _same_report(amp, want[s]["amplification"])
    g.close()
    ref.close()


def test_level_gauges_removed_when_level_drains():
    """A full L0 compaction drains level 0 — its depth and runs gauges
    disappear from exports, not freeze at stale values."""
    g = LSMGraph(pcfg(l0_run_limit=64), device="cpu")
    _ingest(g, n_batches=3)
    g.flush_memgraph()
    label = g.obs_label
    assert obs.REGISTRY.find("store_l0_depth", store=label)
    assert obs.REGISTRY.find("store_level_runs", store=label, level="0")
    g.compact_l0()
    assert not obs.REGISTRY.find("store_l0_depth", store=label)
    assert not obs.REGISTRY.find("store_level_runs", store=label,
                                 level="0")
    assert obs.REGISTRY.find("store_level_runs", store=label, level="1")
    g.close()


def test_read_accounting_overhead_bounded():
    """The resolve wrapper's additions (3 counter incs + one trace-ring
    attribute check) stay far below resolve cost."""
    g = LSMGraph(pcfg(), device="cpu")
    n = 20_000

    def accounting():
        q, p, r = (g._obs_read_queries, g._obs_read_probes,
                   g._obs_read_returned)
        reg = obs.REGISTRY
        t0 = time.perf_counter()
        for _ in range(n):
            q.inc(64)
            p.inc(5)
            r.inc(1280)
            if reg.trace_ring is not None:
                pass
        return time.perf_counter() - t0

    per_call = min(accounting() for _ in range(3)) / n
    assert per_call < 60e-6, \
        f"read accounting costs {per_call*1e6:.2f}us per resolve"
    g.close()


def test_obs_surface_matches_reference():
    """The port's ``repro_torch.obs`` exports the reference's names."""
    assert set(obs.__all__) == set(jobs.__all__)
    for name in obs.__all__:
        assert hasattr(obs, name), name
    assert isinstance(obs.REGISTRY.histogram("t_surface_seconds"), Histogram)
