"""LSMGraph graph service: streaming updates + concurrent analytics.

The paper's Fig 1 scenario: a storage service ingesting an edge stream while
analytics (PageRank / BFS / SSSP) run against consistent snapshots.

    PYTHONPATH=src python -m repro_torch.launch.graph_service \
        --vertices 2000 --edges 30000 --analytics pagerank

The port of ``repro.launch.graph_service``: the same phases, flags and
printed lines, on the port's store.  Every store of a run lives on
``--device`` (default: the current CUDA card; the run fails when there is
none, unless ``--device cpu`` is given).  ``main(argv)`` takes an argument
vector, so a caller can run the service in its own process.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .. import obs
from ..analytics import (bfs, cc, materialize_csr, multilevel_pagerank,
                         multilevel_views, pagerank, scan_stats, sssp)
from ..core import StoreConfig
from ..core.concurrent import ConcurrentLSMGraph
from ..core.types import resolve_device
from ..data.graphgen import powerlaw_edges, update_stream

REPORT_SCHEMA = "lsmg-metrics-report-v1"


class _MetricsReport:
    """Accumulates one full registry export per completed phase and keeps
    the destination current: a FILE is atomically rewritten after every
    phase (a crash mid-run still leaves a valid report of the phases that
    finished); '-' prints a one-line digest per phase and the full
    hierarchical JSON at the end."""

    def __init__(self, dest: str):
        self.dest = dest
        self.doc = {"schema": REPORT_SCHEMA, "phases": {}}
        # Derived-metric refreshers (amplification ledgers): run before
        # every export so each phase report carries current ratios.
        self.refresh = []

    def phase(self, name: str) -> None:
        for cb in self.refresh:
            cb()
        snap = obs.export_json(obs.REGISTRY)
        self.doc["phases"][name] = snap
        if self.dest == "-":
            fams = {f: len(m) for f, m in snap["families"].items()}
            print(f"metrics[{name}]: families={fams}")
        else:
            tmp = self.dest + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.doc, f, indent=1, sort_keys=True)
            import os
            os.replace(tmp, self.dest)

    def finish(self) -> None:
        if self.dest == "-":
            print(json.dumps(self.doc, indent=1, sort_keys=True))
        else:
            print(f"metrics: report written to {self.dest} "
                  f"({len(self.doc['phases'])} phases)")


class _NullReport:
    def __init__(self):
        self.refresh = []

    def phase(self, name: str) -> None:
        pass

    def finish(self) -> None:
        pass


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=2000)
    ap.add_argument("--edges", type=int, default=30000)
    ap.add_argument("--analytics", default="pagerank",
                    choices=["pagerank", "bfs", "sssp", "cc", "scan",
                             "pagerank-multilevel", "2hop"])
    ap.add_argument("--queries", type=int, default=1000,
                    help="batched point-read phase: number of neighbor "
                         "queries resolved in one neighbors_batch call "
                         "(0 disables)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=0, metavar="N",
                    help="run the sharded service tier: N vertex-range "
                         "LSMGraph shards behind routed writes and "
                         "gathered batched reads (0 = single store). "
                         "Composes with --durable (per-shard WALs, "
                         "per-batch acks) and --queries/2hop phases; "
                         "CSR-materializing analytics need the single "
                         "store")
    ap.add_argument("--durable", default=None, metavar="DIR",
                    help="run against a durable store rooted at DIR (WAL + "
                         "segment files + manifest) and finish with a "
                         "restart-and-verify phase: close, recover, and "
                         "check the edge set survived")
    ap.add_argument("--wal-sync", default="batch",
                    choices=["always", "batch", "off"],
                    help="WAL fsync policy in --durable mode")
    ap.add_argument("--metrics", nargs="?", const="-", default=None,
                    metavar="FILE",
                    help="dump a hierarchical metrics report (every "
                         "registered counter/gauge/histogram, grouped by "
                         "family) after each phase; FILE = rewrite a JSON "
                         "report there, bare flag = print to stdout at the "
                         "end")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record the span trace ring for the whole run and "
                         "write it as Chrome trace-event / Perfetto JSON "
                         "to FILE at exit (open at ui.perfetto.dev): "
                         "flush/compaction/resolve spans plus lifecycle "
                         "instants (rotate, commit, quarantine, fence)")
    ap.add_argument("--chaos", action="store_true",
                    help="fault-injection phase (needs --shards and "
                         "--durable): corrupt one shard's newest segment "
                         "on disk, show degraded-mode serving (healthy "
                         "shards answer, the bad range is reported, writes "
                         "to the fenced shard get backpressure), then heal "
                         "it with reopen_shard and verify equivalence")
    ap.add_argument("--device", default=None,
                    help="device of every store of the run (default: the "
                         "current CUDA card; fails when there is none)")
    args = ap.parse_args(argv)
    if args.chaos and not (args.shards > 0 and args.durable):
        ap.error("--chaos requires --shards N and --durable DIR")
    args.device = resolve_device(args.device)
    report = _MetricsReport(args.metrics) if args.metrics else _NullReport()
    if args.trace:
        obs.REGISTRY.enable_tracing(capacity=65536)

    v = args.vertices
    cfg = StoreConfig(vmax=v, mem_edges=1 << 12, seg_size=8,
                      n_segments=1 << 12, hash_slots=1 << 13,
                      ovf_cap=1 << 13, batch_cap=1 << 10,
                      l0_run_limit=4, seg_target_edges=1 << 13)
    if args.shards > 0:
        _run_sharded(args, cfg, report)
        _write_trace(args)
        return
    if args.durable:
        from ..storage import open_store
        g = ConcurrentLSMGraph(
            store=open_store(args.durable, cfg, device=args.device,
                             wal_sync=args.wal_sync))
    else:
        g = ConcurrentLSMGraph(cfg, device=args.device)
    report.refresh.append(obs.AmplificationLedger(g.store).refresh_gauges)
    src, dst = powerlaw_edges(v, args.edges, seed=args.seed)

    n_ops, _, t_ingest = _ingest_stream(g, src, dst, g.flush)
    print(f"ingested {n_ops} ops in {t_ingest:.2f}s "
          f"({n_ops/t_ingest:.0f} ops/s); levels={g.store.level_sizes()}")
    report.phase("ingest")

    snap = g.snapshot()
    t0 = time.time()
    if args.analytics == "pagerank-multilevel":
        res = multilevel_pagerank(multilevel_views(snap), n_out=v, iters=10)
        top = np.argsort(-res.cpu().numpy())[:5]
    elif args.analytics == "2hop":
        top = _two_hop(snap, v, args.seed)
    else:
        view = materialize_csr(snap, v)
        if args.analytics == "pagerank":
            res = pagerank(view, iters=10)
            top = np.argsort(-res.cpu().numpy())[:5]
        elif args.analytics == "bfs":
            res = bfs(view, 0)
            top = res.cpu().numpy()[:5]
        elif args.analytics == "sssp":
            res = sssp(view, 0)
            top = res.cpu().numpy()[:5]
        elif args.analytics == "cc":
            res = cc(view)
            top = np.unique(res.cpu().numpy())[:5]
        else:
            deg, _ = scan_stats(view)
            top = np.argsort(-deg.cpu().numpy())[:5]
    print(f"{args.analytics} in {time.time()-t0:.2f}s; top: {top}")
    report.phase("analytics")
    _query_phase(snap, v, args, label="batched reads")
    report.phase("queries")
    _concurrent_read_phase(g, v, args)
    report.phase("concurrent_reads")
    print(f"io: {g.store.io}")
    if args.durable:
        # Restart-and-verify: recover the directory and check the edge set
        # survived WAL replay + manifest-driven segment reload.  The
        # concurrent-read phase ingested more edges after `snap` was
        # pinned, so re-pin (after draining the ingest queue) or the
        # verify would diff a stale state against the recovered one.
        from ..storage import open_store
        g.flush()
        snap.release()
        snap = g.snapshot()
        _restart_verify(snap, g, disk=g.store.disk_bytes(),
                        reopen=lambda: open_store(args.durable,
                                                  device=args.device),
                        where="on disk")
        report.phase("restart_verify")
    else:
        snap.release()
        g.close()
    report.finish()
    _write_trace(args)


def _write_trace(args) -> None:
    if not args.trace:
        return
    n = obs.export_chrome_trace(args.trace, obs.REGISTRY)
    print(f"trace: {n} events written to {args.trace} "
          "(Chrome trace-event JSON; open at ui.perfetto.dev)")


# --------------------------------------------------------- shared phases
def _ingest_stream(g, src, dst, flush):
    """Shared ingest loop (undirected doubling).  Returns (n_ops, last
    write receipt/seq, seconds incl. the final flush)."""
    t0 = time.time()
    n_ops = 0
    last = None
    for op, s, d in update_stream(src, dst):
        if op == "insert":
            last = g.insert_edges(np.r_[s, d], np.r_[d, s])  # undirected
        else:
            last = g.delete_edges(np.r_[s, d], np.r_[d, s])
        n_ops += 2 * len(s)
    flush()
    return n_ops, last, time.time() - t0


def _two_hop(snap, v: int, seed: int) -> np.ndarray:
    """Service-style traversal: one batched resolve per hop instead of a
    per-vertex dispatch loop (the batched read subsystem's fast path)."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, v, 64).astype(np.int64)
    hop1 = snap.neighbors_batch(seeds)
    frontier = (np.unique(np.concatenate(hop1))
                if any(len(h) for h in hop1) else np.empty(0, np.int64))
    hop2 = snap.neighbors_batch(frontier)
    reach = sum(len(h) for h in hop2)
    return np.asarray([len(seeds), len(frontier), reach])


def _query_phase(snap, v: int, args, label: str) -> None:
    """Timed batched point-read phase: the whole query batch resolves in a
    constant number of device passes over the visible runs."""
    if args.queries <= 0:
        return
    rng = np.random.default_rng(args.seed + 1)
    qs = rng.integers(0, v, args.queries).astype(np.int64)
    snap.neighbors_batch(qs)  # warm up (spine build) at the timed shape
    t0 = time.time()
    nbrs = snap.neighbors_batch(qs)
    dt = time.time() - t0
    hits = sum(len(x) > 0 for x in nbrs)
    print(f"{label}: {args.queries} vertices in {dt*1e3:.1f} ms "
          f"({args.queries/max(dt, 1e-9):.0f} q/s; {hits} non-empty)")


def _concurrent_read_phase(g, v: int, args, n_readers: int = 4,
                           duration: float = 1.0) -> None:
    """Readers-under-ingest probe: ``n_readers`` threads pin fresh
    snapshots and resolve batched reads while the service keeps ingesting
    at full rate.  Every ``snapshot()`` here is one lock-free load of the
    epoch-published StoreState — the printed tail latency is the live
    demonstration that writers never block readers."""
    if args.queries <= 0:
        return
    import threading

    rng = np.random.default_rng(args.seed + 3)
    qs = rng.integers(0, v, min(args.queries, 256)).astype(np.int64)
    wsrc, wdst = powerlaw_edges(v, 4096, seed=args.seed + 4)
    # Warm the probe's read shape and spine before the clock starts; a
    # couple of write+read cycles also run the splice path.
    for i in range(2):
        g.insert_edges(wsrc[i * 256:(i + 1) * 256],
                       wdst[i * 256:(i + 1) * 256])
        snap = g.snapshot()
        snap.neighbors_batch(qs)
        snap.release()
    stop = threading.Event()
    lats = [[] for _ in range(n_readers)]

    def reader(slot):
        while not stop.is_set():
            t0 = time.time()
            snap = g.snapshot()
            snap.neighbors_batch(qs)
            snap.release()
            slot.append(time.time() - t0)

    threads = [threading.Thread(target=reader, args=(lats[i],),
                                name=f"svc-reader-{i}")
               for i in range(n_readers)]
    for t in threads:
        t.start()
    n_wr = 0
    t0 = time.time()
    while time.time() - t0 < duration:
        off = n_wr % (len(wsrc) - 128)
        g.insert_edges(wsrc[off:off + 128], wdst[off:off + 128])
        n_wr += 128
        time.sleep(0.01)  # writer cadence: steady stream, not a DoS loop
    stop.set()
    for t in threads:
        t.join()
    w_dt = time.time() - t0
    all_lat = np.array([x for slot in lats for x in slot])
    if len(all_lat) == 0:
        return
    p50, p99 = np.percentile(all_lat, [50, 99])
    print(f"concurrent reads: {n_readers} readers x {len(all_lat)} calls "
          f"under full-rate ingest — p50={p50*1e3:.1f} ms "
          f"p99={p99*1e3:.1f} ms; writer {n_wr/w_dt:.0f} edges/s")


def _restart_verify(snap, g, *, disk: int, reopen, where: str) -> None:
    """Close, recover via ``reopen()``, and check the edge set survived."""
    pre = snap.edge_set()
    snap.release()
    g.close()
    t0 = time.time()
    g2 = reopen()
    t_rec = time.time() - t0
    with g2.snapshot() as snap2:
        post = snap2.edge_set()
    match = "OK" if post == pre else "MISMATCH"
    print(f"durable: {disk} bytes {where}; recovered {len(post)} edges "
          f"in {t_rec:.2f}s after restart: {match}")
    g2.close()
    if match != "OK":
        raise SystemExit("restart-and-verify FAILED")


def _run_sharded(args, cfg, report) -> None:
    """The sharded service tier: routed ingest with per-batch durability
    acks, an epoch-consistent snapshot, gathered batched point-reads, and
    (durable mode) a per-shard restart-and-verify phase."""
    from ..shard import (CompactionScheduler, ShardedGraphStore,
                         open_sharded_store)

    v = args.vertices
    if args.durable:
        g = open_sharded_store(args.durable, cfg, device=args.device,
                               n_shards=args.shards, wal_sync=args.wal_sync)
    else:
        g = ShardedGraphStore(cfg, args.shards, device=args.device)
    # Closure over g.shards (not the ledgers): reopen_shard swaps stores,
    # and a fresh ledger per refresh always tracks the live set.
    report.refresh.append(lambda: [
        obs.AmplificationLedger(sh).refresh_gauges() for sh in g.shards])
    src, dst = powerlaw_edges(v, args.edges, seed=args.seed)

    # Amplification-driven background compaction: the scheduler drains the
    # worst-ranked idle shard between ingest bursts, so the explicit
    # compact_all barrier disappears from the serving path.
    sched = CompactionScheduler(g).start()
    t0 = time.time()
    n_ops, receipt, _ = _ingest_stream(g, src, dst, flush=lambda: None)
    ack_line = None
    t_ack = 0.0
    if args.durable and receipt is not None:
        # Ack BEFORE the flush barrier: flush rotates (fsyncs) every WAL,
        # so acking afterwards would time a no-op — this measures the real
        # group-commit wait for the last batch's shards only.
        ta = time.time()
        g.ack(receipt)
        t_ack = time.time() - ta
        ack_line = (f"ack(last batch) over shards {sorted(receipt.seqs)} "
                    f"in {t_ack*1e3:.1f} ms")
    g.flush_all()
    # Headline matches the single-store path: ingest + flush, ack excluded
    # (it is reported on its own line).
    t_ingest = time.time() - t0 - t_ack
    per_shard = [sum(sz) for sz in g.level_sizes()]
    print(f"ingested {n_ops} ops into {g.n_shards} shards in "
          f"{t_ingest:.2f}s ({n_ops/t_ingest:.0f} ops/s); "
          f"edges/shard={per_shard}")
    if ack_line:
        print(ack_line)
    report.phase("ingest")

    snap = g.snapshot()
    print(f"epoch={snap.epoch} taus={snap.taus}")
    if args.analytics == "2hop":
        t0 = time.time()
        top = _two_hop(snap, v, args.seed)
        print(f"2hop in {time.time()-t0:.2f}s; top: {top.tolist()}")
    else:
        print(f"({args.analytics} analytics need the single-store CSR "
              "path; skipped in --shards mode)")
    report.phase("analytics")
    _query_phase(snap, v, args, label="sharded batched reads")
    report.phase("queries")
    sched.stop()
    decisions = {d: c.value for d, c in sched._obs_decision.items()
                 if c.value}
    print(f"compaction scheduler: {decisions or 'no ticks'}; "
          f"L0 depths={[len(sh._state.levels[0]) for sh in g.shards]}")
    if args.chaos:
        snap.release()
        _chaos_phase(g, v, args)
        report.phase("chaos")
        snap = g.snapshot()  # re-pin post-heal for restart-and-verify
    if args.durable:
        _restart_verify(snap, g, disk=g.disk_bytes(),
                        reopen=lambda: open_sharded_store(
                            args.durable, device=args.device),
                        where=f"across {args.shards} shard dirs")
        report.phase("restart_verify")
    else:
        snap.release()
        g.close()
    report.finish()


def _chaos_phase(g, v: int, args) -> None:
    """Survive-the-disk demo: flip one bit in a victim shard's newest
    segment, evict page-cache arrays so reads must hit disk, and show the
    failure-isolation contract — healthy shards keep answering with a
    typed report on the masked range, writes touching the fenced shard get
    backpressure, and ``reopen_shard`` heals back to full equivalence."""
    import os

    from ..shard import ShardUnavailable
    from ..storage import faultfs

    with g.snapshot() as s:
        oracle = s.edge_set()
    # The victim is the newest L0 run of the first shard that has one: a
    # flush segment, which recovery rebuilds from its retained WAL
    # generation.  (The reference takes the newest segment file of any
    # level; when a compaction wrote it last, there is no WAL to rebuild it
    # from, the shard reopens degraded and the heal fails.)
    victim, seg = None, None
    for cand in range(g.n_shards):
        l0 = [r.fid for r in g.shards[cand].levels[0] if r.nv > 0]
        if l0:
            victim, seg = cand, os.path.join(
                g.shard_roots[cand], "segments", "seg-%08d.csr" % max(l0))
            break
    if victim is None:
        print("chaos: no flush segment on disk to corrupt; skipped")
        return
    faultfs.flip_bit(seg)
    for shard in g.shards:
        if shard.durability is not None:
            shard.durability.evict_all_segments()
    print(f"chaos: flipped one bit in shard {victim}'s "
          f"{os.path.basename(seg)}")

    rng = np.random.default_rng(args.seed + 2)
    qs = rng.integers(0, v, 256).astype(np.int64)
    t0 = time.time()
    with g.snapshot() as s:
        res, rep = s.neighbors_batch(qs, with_report=True)
    healthy = sum(len(r) > 0 for i, r in enumerate(res)
                  if i not in set(rep.positions.tolist()))
    print(f"chaos: degraded read of {len(qs)} vertices in "
          f"{(time.time()-t0)*1e3:.1f} ms — {len(rep.positions)} masked "
          f"(shards {list(rep.shards)}), {healthy} healthy non-empty")
    for s_id, entry in g.health_report().items():
        print(f"chaos:   shard {s_id} [{entry['range'][0]},"
              f"{entry['range'][1]}] {entry['status']}"
              + (f" — {entry['reason']}" if "reason" in entry else ""))
    lo, hi = g.part.shard_range(victim)
    try:
        g.insert_edges(np.array([lo], np.int64), np.array([0], np.int64))
        print("chaos: ERROR — write to fenced shard was accepted")
        raise SystemExit("chaos phase FAILED")
    except ShardUnavailable as e:
        print(f"chaos: write to fenced shard rejected (backpressure): {e}")

    t0 = time.time()
    g.reopen_shard(victim)
    with g.snapshot() as s:
        post = s.edge_set()
    ok = post == oracle
    print(f"chaos: reopen_shard({victim}) in {time.time()-t0:.2f}s; "
          f"edge set "
          f"{'restored — byte-for-byte equivalent' if ok else 'MISMATCH'}; "
          f"health={[e['status'] for e in g.health_report().values()]}")
    if not ok:
        raise SystemExit("chaos phase FAILED: edge set not restored")


if __name__ == "__main__":
    main()
