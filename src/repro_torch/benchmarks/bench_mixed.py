"""Fig 18: update-analysis mixed workload — concurrent ingest throughput and
SSSP latency against live snapshots (paper §5.7), plus the read-throughput-
under-ingest section: reader tail latency with a full-rate writer, the
direct measurement of the epoch-published StoreState claim (readers never
block on writer-held locks, plain applies reuse the shared read spine).
The port of ``benchmarks/bench_mixed.py``: every store on the suite's
device, launched from the writer, reader and scheduler threads."""
from __future__ import annotations

import threading
import time

import numpy as np

from ..analytics import materialize_csr, sssp
from ..core.concurrent import ConcurrentLSMGraph
from ..core.store import LSMGraph
from ..obs.registry import Histogram
from .common import (cli_device, emit, graph_edges, scale, store_cfg,
                     suite_device, sync)


def run(device=None) -> list:
    dev = suite_device(device)
    V = scale().V
    src, dst = graph_edges(seed=5)
    cut = int(0.8 * len(src))
    g = ConcurrentLSMGraph(store_cfg(), device=dev)
    g.insert_edges(src[:cut], dst[:cut])
    g.flush()

    # concurrent phase: stream the rest while running SSSP on snapshots
    t0 = time.perf_counter()
    chunk = 2048
    sssp_times = []
    for off in range(cut, len(src), chunk):
        g.insert_edges(src[off:off + chunk], dst[off:off + chunk])
        t1 = time.perf_counter()
        snap = g.snapshot()
        view = materialize_csr(snap, V)
        sssp(view, int(src[0]))
        sync(dev)
        snap.release()
        sssp_times.append(time.perf_counter() - t1)
    g.flush()
    sync(dev)
    dt = time.perf_counter() - t0
    g.close()
    n = len(src) - cut
    return [
        ("fig18_mixed_ingest", dt / n * 1e6, f"eps={n/dt:.0f}"),
        ("fig18_mixed_sssp", float(np.mean(sssp_times)) * 1e6,
         f"n_runs={len(sssp_times)}"),
    ]


def _reader_phase(g: LSMGraph, queries: np.ndarray, n_readers: int,
                  duration: float) -> Histogram:
    """``n_readers`` threads loop snapshot -> neighbors_batch -> release
    for ``duration`` seconds; per-call latencies land in a shared
    high-resolution ``obs`` histogram (thread-safe observe, so no
    per-thread slots to concatenate) returned for percentile extraction."""
    stop = threading.Event()
    hist = Histogram("bench_read_latency_seconds", buckets_per_decade=60)

    def loop() -> None:
        while not stop.is_set():
            t0 = time.perf_counter()
            snap = g.snapshot()
            snap.neighbors_batch(queries)
            snap.release()
            hist.observe(time.perf_counter() - t0)

    threads = [threading.Thread(target=loop, name=f"bench-reader-{i}")
               for i in range(n_readers)]
    for t in threads:
        t.start()
    time.sleep(duration)
    stop.set()
    for t in threads:
        t.join()
    return hist


def run_read_under_ingest(device=None) -> list:
    """Reader p50/p99 with the writer idle vs ingesting at full rate.

    The epoch-published StoreState makes two promises measurable here:
    ``snapshot()`` is one atomic state load (no writer lock to block on),
    and a plain apply publish REUSES the shared read spine — so reader
    latency under a full-rate writer should stay within a small factor of
    idle (the acceptance bar: p99 ratio <= 1.5x at 4 reader threads).

    The MemGraph is sized to absorb the whole write phase: the claim under
    test is apply-publish churn (the per-batch steady state), so the writer
    is budgeted to stop just short of a rotation — flush/compaction impact
    on pinned readers is covered by the concurrency stress tests, and a
    toy-scale store that flushes every few chunks would only measure spine
    rebuilds."""
    dev = suite_device(device)
    sc = scale()
    V = sc.V
    n_readers = 2 if sc.smoke else 4
    duration = 0.3 if sc.smoke else 2.0
    from ..core import StoreConfig
    cfg = StoreConfig(
        vmax=V, mem_edges=1 << 15, seg_size=8, n_segments=1 << 12,
        hash_slots=1 << 16, ovf_cap=1 << 15, batch_cap=1 << 9,
        l0_run_limit=4, seg_target_edges=1 << 13)
    src, dst = graph_edges(seed=7)
    g = LSMGraph(cfg, device=dev)
    cut = len(src) // 2
    g.insert_edges(src[:cut], dst[:cut])
    g.flush_memgraph()
    queries = np.unique(src[:4096])[:256].astype(np.int64)
    # Warm the shared spine, the apply path, and the first kernel builds
    # and launches before either phase measures.
    snap = g.snapshot()
    snap.neighbors_batch(queries)
    snap.release()
    g.insert_edges(src[cut:cut + 512], dst[cut:cut + 512])
    snap = g.snapshot()
    snap.neighbors_batch(queries)
    snap.release()

    idle = _reader_phase(g, queries, n_readers, duration)

    # Full-rate writer: stream the tail in a tight loop (wrapping if it
    # drains early) while the readers hammer; bounded by the MemGraph
    # budget so no rotation lands mid-measurement.
    stop = threading.Event()
    n_written = [0]
    budget = cfg.mem_edges - 4096 - 512

    def writer() -> None:
        chunk = 256
        off = cut + 512
        while not stop.is_set() and n_written[0] < budget:
            end = min(len(src), off + chunk)
            g.insert_edges(src[off:end], dst[off:end])
            n_written[0] += end - off
            off = end if end < len(src) else cut
    wt = threading.Thread(target=writer, name="bench-writer")
    wt.start()
    t0 = time.perf_counter()
    ingest = _reader_phase(g, queries, n_readers, duration)
    stop.set()
    wt.join()
    sync(dev)
    w_dt = time.perf_counter() - t0

    p50_i, p99_i = idle.percentiles([50, 99])
    p50_w, p99_w = ingest.percentiles([50, 99])
    ratio = p99_w / p99_i if p99_i > 0 else float("inf")
    eps = n_written[0] / w_dt if w_dt > 0 else 0.0
    return [
        ("read_under_ingest_idle_p50", p50_i * 1e6,
         f"readers={n_readers}"),
        ("read_under_ingest_idle_p99", p99_i * 1e6,
         f"n_calls={idle.snapshot()['count']}"),
        ("read_under_ingest_busy_p50", p50_w * 1e6,
         f"readers={n_readers}"),
        ("read_under_ingest_busy_p99", p99_w * 1e6,
         f"n_calls={ingest.snapshot()['count']}"),
        ("read_under_ingest_p99_ratio", ratio * 1e6,  # ratio, not us
         f"busy/idle={ratio:.2f}x"),
        ("read_under_ingest_writer_rate", (w_dt / max(n_written[0], 1)) * 1e6,
         f"eps={eps:.0f}"),
    ]


def run_scheduler(device=None) -> list:
    """Writer ack p99 with the compaction scheduler on vs off.

    A bursty skewed writer (90% of each batch lands on shard 0, with
    think-time gaps between bursts) acks every batch on a 2-shard durable
    store whose L0 limit never auto-compacts.  Off: L0 debt accrues
    unbounded on the hot shard.  On: the scheduler compacts the worst
    shard inside the gaps — hot-skip + ack-latency backoff are exactly the
    mechanisms keeping the writer-side p99 flat.  Acceptance:
    p99_ratio <= 1.2x while the hottest shard's final L0 depth drops."""
    import shutil
    import tempfile

    from ..core import StoreConfig
    from ..shard import CompactionScheduler, open_sharded_store

    dev = suite_device(device)
    sc = scale()
    V = sc.V
    n_bursts, per_burst, batch = (6, 5, 256) if sc.smoke else (30, 5, 256)
    cfg = StoreConfig(
        vmax=V, mem_edges=1 << 10, seg_size=8, n_segments=1 << 12,
        hash_slots=1 << 13, ovf_cap=1 << 13, batch_cap=1 << 9,
        l0_run_limit=256, seg_target_edges=1 << 13)
    out = {}
    # Prime phase (discarded): the first kernel builds and launches of
    # ingest/flush/compaction land process-wide, so whichever measured
    # phase ran first would otherwise carry them all in its p99.
    for mode in ("prime", "off", "on"):
        root = tempfile.mkdtemp(prefix=f"lsmg-bench-sched-{mode}-")
        g = open_sharded_store(root, cfg, n_shards=2, wal_sync="batch",
                               device=dev)
        sched = (CompactionScheduler(g, interval=0.005).start()
                 if mode in ("on", "prime") else None)
        bursts = 2 if mode == "prime" else n_bursts
        comp0 = (sum(c.value for c in sched._obs_compactions)
                 if sched else 0)
        rng = np.random.default_rng(19)
        hist = Histogram("bench_ack_seconds", buckets_per_decade=60)
        lo, hi = g.part.shard_range(0)
        n0 = int(batch * 0.9)
        for _ in range(bursts):
            for _ in range(per_burst):
                s = np.concatenate([
                    rng.integers(lo, hi, n0),
                    rng.integers(0, V, batch - n0)]).astype(np.int64)
                d = rng.integers(0, V, batch).astype(np.int64)
                t0 = time.perf_counter()
                r = g.insert_edges(s, d)
                g.ack(r)
                sync(dev)
                hist.observe(time.perf_counter() - t0)
            time.sleep(0.01)        # think time: the scheduler's window
        if sched is not None:
            sched.stop()
        depth = max(len(sh._state.levels[0]) for sh in g.shards)
        comp = (sum(c.value for c in sched._obs_compactions) - comp0
                if sched else 0)
        g.close()
        shutil.rmtree(root, ignore_errors=True)
        if mode != "prime":
            out[mode] = (hist.percentile(99), depth, comp)
    p99_off, p99_on = out["off"][0], out["on"][0]
    ratio = p99_on / p99_off if p99_off > 0 else float("inf")
    return [
        ("mixed_sched_off_ack_p99", p99_off * 1e6,
         f"l0_max={out['off'][1]}"),
        ("mixed_sched_on_ack_p99", p99_on * 1e6,
         f"l0_max={out['on'][1]};p99_ratio={ratio:.2f}x;"
         f"compactions={out['on'][2]}"),
    ]


def main(device=None) -> None:
    emit(run(device))
    emit(run_read_under_ingest(device))
    emit(run_scheduler(device))


if __name__ == "__main__":
    main(cli_device())
