#!/usr/bin/env python3
"""Smoke run of the PyTorch port of LSMGraph on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--edges N]

Phases, each of which must pass (exit code 1 otherwise, with no result
line):

1. Environment: the card's name and power limit, the torch and CUDA
   versions, and the build of every CUDA kernel from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes: the presence filter test on 2048 runs of real filters and
   16384 queries, and the merge permutation of 2**24 and 2**22 sorted key
   triples with duplicate keys.  Both must be byte-equal; the kernel's time,
   the plain version's time and the least time the card could take (its
   bound) are printed.
3. The main path at a realistic scale: Graph500 R-MAT scale 22, edgefactor
   16 (A/B/C = 0.57/0.19/0.19), streamed through one in-memory ``LSMGraph``
   with the paper's 20:1 insert:delete mix, no final flush, so the active
   MemGraph, L0, L1 and L2 are all live; then one snapshot and
   ``neighbors_batch`` on 65,536 random vertices plus the 64 of highest
   degree, compared exactly with a numpy last-writer-wins oracle.  The
   launch counters are zeroed before this phase and every kernel must have
   launched in it.
4. A ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and the last line
   ``{"ok": true, "device": {...}}``.

The port imports neither ``jax`` nor the JAX package; this script neither.
There is no CPU fallback: with no CUDA device the script fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
INT32_OPS_PER_S = 67e12        # H100 SXM non-tensor 32-bit rate (data sheet)
SCALE = 22
EDGEFACTOR = 16


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, nops: float):
    """Least time the card could take: bytes over the memory rate or
    operations over the peak rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 2
def check_presence(dev, rng):
    import torch
    from repro_torch.core import filters
    from repro_torch.core.store import _stack_presence
    from repro_torch.kernels import presence
    # Two L0-sized runs and 2046 segment-sized runs, as the main path has.
    sizes = [600_000] * 2 + [4_000] * 2046
    runs, keysets = [], []
    for n in sizes:
        keys = np.unique(rng.integers(0, 1 << SCALE, n))
        keysets.append(keys)
        runs.append((SimpleNamespace(presence=filters.from_vkeys(keys)), 0))
    words, offs, masks = _stack_presence(runs, dev)
    b = 16384
    q = np.concatenate([rng.choice(np.concatenate(keysets[:8]), b // 2),
                        rng.integers(0, 1 << SCALE, b - b // 2)])
    queries = torch.from_numpy(q.astype(np.int32)).to(dev)
    got = presence.presence_matrix_cuda(words, offs, masks, queries)
    want = presence.presence_matrix_ref(words, offs, masks, queries)
    torch.cuda.synchronize()
    err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"presence kernel differs from plain: {err}")
    r = offs.shape[0]
    nbytes = words.numel() * 4 + r * 12 + b * 4 + r * b
    # Two 10-op hashes per query, then k probes of ~6 ops per pair.
    nops = b * 20 + r * b * filters.FILTER_K * 6
    t_bound, by = bound(nbytes, nops)
    return dict(
        name="presence_matrix", route="cuda",
        source="src/repro_torch/csrc/presence.cu",
        replaces="src/repro/kernels/presence.py:85",
        max_abs_err=err,
        ms=time_ms(lambda: presence.presence_matrix_cuda(
            words, offs, masks, queries)),
        plain_ms=time_ms(lambda: presence.presence_matrix_ref(
            words, offs, masks, queries), iters=3, warmup=1),
        bound_ms=t_bound, bound_by=by, library_ms=None,
        shape=f"R={r} runs, {words.numel()} words, B={b} queries")


def _sorted_triples(n: int, gen, dev):
    import torch
    from repro_torch.core.csr import lexsort_edges
    k1 = torch.randint(0, 1 << 20, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    k2 = torch.randint(0, 64, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    k3 = torch.randint(0, 16, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    o = lexsort_edges(k1, k2, k3)
    return tuple(k[o].contiguous() for k in (k1, k2, k3))


def check_merge_perm(dev, seed):
    import torch
    from repro_torch.kernels import merge
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    a = _sorted_triples(1 << 24, gen, dev)
    b = _sorted_triples(1 << 22, gen, dev)
    na, nb = a[0].shape[0], b[0].shape[0] - 5    # 5 pad slots at the tail
    got = merge.merge_perm_cuda(a, b, na, nb)
    want = merge.merge_perm_plain(a, b, na, nb)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"merge_perm kernel differs from plain: {err}")
    cap = a[0].shape[0] + b[0].shape[0]
    # Three int32 keys in and one int32 index out per record; a merge needs
    # one 3-key comparison (~5 ops) per output.
    t_bound, by = bound(16 * cap, 5 * cap)
    return dict(
        name="merge_perm", route="cuda",
        source="src/repro_torch/csrc/merge_perm.cu",
        replaces="src/repro/kernels/merge.py:199",
        max_abs_err=err,
        ms=time_ms(lambda: merge.merge_perm_cuda(a, b, na, nb)),
        plain_ms=time_ms(lambda: merge.merge_perm_plain(a, b, na, nb),
                         iters=3, warmup=1),
        bound_ms=t_bound, bound_by=by, library_ms=None,
        shape=f"A={na}, B={nb} (+5 pad) sorted (src,dst,ts) triples")


# ------------------------------------------------------------------ phase 3
def graph500_edges(n_edges: int, seed: int, scale: int = SCALE):
    """The first ``n_edges`` distinct (src, dst) pairs of the R-MAT stream,
    in generation order.  Duplicates are dropped: the store's compaction GC
    (held byte-equal to the JAX package's) resurrects a deleted edge whose
    earlier duplicate insert sits on a deeper level (ROADMAP, faults)."""
    from repro_torch.data import rmat_edges
    parts_s, parts_d, seen = [], [], 0
    draw = int(n_edges * 1.06) + 1024
    while seen < n_edges:
        s, d = rmat_edges(scale, draw, seed=seed + len(parts_s))
        parts_s.append(s)
        parts_d.append(d)
        src, dst = np.concatenate(parts_s), np.concatenate(parts_d)
        key = (src.astype(np.int64) << 32) | dst.astype(np.int64)
        _, first = np.unique(key, return_index=True)
        seen = first.shape[0]
    first = np.sort(first)[:n_edges]
    return src[first], dst[first]


def lww_oracle(src, dst, ins, queries):
    """numpy last-writer-wins adjacency of the queried sources: per source,
    the sorted dsts whose last record in stream order is an insert."""
    sel = np.nonzero(np.isin(src, queries))[0]
    s, d, live = src[sel], dst[sel], ins[sel]
    order = np.lexsort((sel, d, s))
    s, d, live = s[order], d[order], live[order]
    last = np.ones(len(s), bool)
    last[:-1] = (s[:-1] != s[1:]) | (d[:-1] != d[1:])
    keep = last & live
    s, d = s[keep], d[keep]
    offs = np.searchsorted(s, np.append(queries, np.iinfo(np.int64).max))
    return [d[offs[i]:offs[i + 1]].astype(np.int64)
            for i in range(len(queries))]


def main_path(dev, cfg, n_edges: int, n_queries: int, seed: int, log=print):
    """Drive the port's main path; return its measurements."""
    import torch
    from repro_torch import obs
    from repro_torch.core import LSMGraph
    from repro_torch.data import update_stream
    t0 = time.perf_counter()
    src, dst = graph500_edges(n_edges, seed, cfg.vmax.bit_length() - 1)
    log(f"data: {len(src)} distinct R-MAT edges in "
        f"{time.perf_counter() - t0:.1f} s")
    store = LSMGraph(cfg, device=dev)
    label = store.obs_label
    s_parts, d_parts, i_parts = [], [], []
    n_ops = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for kind, s, d in update_stream(src, dst, seed=seed,
                                    chunk=cfg.batch_cap):
        if kind == "insert":
            store.insert_edges(s, d)
        else:
            store.delete_edges(s, d)
        s_parts.append(s)
        d_parts.append(d)
        i_parts.append(np.full(len(s), kind == "insert"))
        n_ops += len(s)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_ingest = time.perf_counter() - t0
    flush = obs.REGISTRY.histogram("store_flush_seconds", store=label)
    apply_s = obs.REGISTRY.histogram("store_apply_seconds", store=label).sum
    comp = obs.REGISTRY.find("store_compaction_seconds", store=label)
    compactions = {h.labels["level"]: h.count for h in comp}
    comp_s = {h.labels["level"]: round(h.sum, 2) for h in comp}
    flushes = flush.count
    sizes = store.level_sizes()
    runs = [len(lvl) for lvl in store.levels]
    log(f"ingest: {n_ops} records in {t_ingest:.1f} s = "
        f"{n_ops / t_ingest:.0f} records/s; flushes {flushes}, "
        f"compactions by target level {compactions}")
    log(f"ingest time (store spans, host clock): MemGraph inserts "
        f"{apply_s:.1f} s, flushes {flush.sum:.1f} s, compactions by "
        f"target level {comp_s} s")
    log(f"levels: edges {sizes}, runs {runs}, "
        f"active MemGraph {store.n_edges_cached()} records")
    live_tiers = [store.n_edges_cached() > 0] + [bool(x) for x in runs[:3]]
    if not all(live_tiers):
        raise AssertionError(f"MemGraph/L0/L1/L2 not all live: {live_tiers}")

    rng = np.random.default_rng(seed + 7)
    s_all = np.concatenate(s_parts).astype(np.int64)
    d_all = np.concatenate(d_parts).astype(np.int64)
    ins_all = np.concatenate(i_parts)
    deg = np.bincount(s_all[ins_all], minlength=cfg.vmax)
    top = np.argsort(-deg, kind="stable")[:64]
    queries = np.unique(np.concatenate([
        rng.choice(cfg.vmax, n_queries, replace=False), top]))
    snap = store.snapshot()
    try:
        t0 = time.perf_counter()
        out = snap.neighbors_batch(queries)
        t_read = time.perf_counter() - t0
    finally:
        snap.release()
    # The first resolve of the snapshot builds the sealed epoch's spine;
    # both are timed by the store's own spans (host clock, each span ends
    # in a device-to-host copy).
    spine = obs.REGISTRY.histogram("read_spine_build_seconds", store=label)
    hist = obs.REGISTRY.histogram("read_resolve_seconds", store=label)
    t_spine = spine.sum
    n_chunks = hist.count
    resolve_ms = (hist.sum - t_spine) / max(n_chunks, 1) * 1e3
    log(f"read: spine over {len(store.runs_by_fid)} runs built in "
        f"{t_spine * 1e3:.1f} ms; {len(queries)} queries in {n_chunks} "
        f"chunks, {resolve_ms:.1f} ms per chunk past the spine build, "
        f"{t_read * 1e3:.1f} ms in all")
    want = lww_oracle(s_all, d_all, ins_all, queries)
    bad = [int(q) for q, g, w in zip(queries, out, want)
           if not np.array_equal(g, w)]
    n_out = sum(len(g) for g in out)
    if bad:
        raise AssertionError(
            f"{len(bad)} of {len(queries)} adjacency lists differ from the "
            f"last-writer-wins oracle, first {bad[:5]}")
    log(f"oracle: {len(queries)} adjacency lists ({n_out} edges, top "
        f"degree {int(deg[top[0]])}) equal to the numpy last-writer-wins "
        f"oracle")
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else 0.0)
    log(f"peak device memory: {peak:.2f} GiB")
    return dict(store=store, query_vertices=queries,
                records=n_ops, ingest_s=t_ingest, apply_s=apply_s,
                flush_s=flush.sum, compaction_s=comp_s, flushes=flushes,
                compactions=compactions, level_sizes=sizes, runs=runs,
                spine_ms=t_spine * 1e3, resolve_ms_per_chunk=resolve_ms,
                queries=len(queries), peak_gib=peak)


def profile_read(store, queries, dev, log=print):
    """Where a read's device time goes: drop the cached spine, then read the
    same queries again under ``torch.profiler`` (spine rebuild included).
    Profiled times are not the run's timings; the split between kernels
    and the device's busy share are what this reports."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = dev.type == "cuda"
    store.drop_read_spine()
    snap = store.snapshot()
    try:
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])) as prof:
            snap.neighbors_batch(queries)
            if cuda:
                torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        snap.release()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"profiled read (spine rebuilt): wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %), "
        f"{sum(r[1] for r in rows)} kernels")
    for ms, n, name in rows[:8]:
        log(f"  {ms:9.2f} ms  {n:6d}x  {name[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                top=[(name[:60], round(ms, 3), n) for ms, n, name in rows[:8]])


def store_config():
    from repro_torch.core import StoreConfig
    return StoreConfig(vmax=1 << 22, mem_edges=1 << 21, seg_size=8,
                       n_segments=1 << 20, hash_slots=1 << 21,
                       ovf_cap=1 << 21, batch_cap=1 << 16, n_levels=5,
                       level_factor=10, l0_run_limit=4,
                       seg_target_edges=1 << 15)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--edges", type=int, default=EDGEFACTOR << SCALE,
                    help="distinct edges to stream (cut only if the time "
                         "limit forces it)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops
    t_all = time.perf_counter()
    smi = smi_line()
    dev = torch.device("cuda", 0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    took = _build.build_all()
    for name, secs in took.items():
        print(f"built {name}.cu in {secs:.1f} s")
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    rows = [check_presence(dev, rng), check_merge_perm(dev, args.seed)]
    for r in rows:
        print(f"kernel {r['name']} ({r['shape']}): byte-equal to plain; "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{smi}]")

    if args.edges != EDGEFACTOR << SCALE:
        print(f"reduced: edges {args.edges} of {EDGEFACTOR << SCALE}")
    ops.reset_launches()
    stats = main_path(dev, store_config(), args.edges, 1 << 16, args.seed)
    launches = ops.launch_counts()
    print(f"main path launches: {launches}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    store, queries = stats.pop("store"), stats.pop("query_vertices")
    print(f"main path: {json.dumps(stats)}")
    profile_read(store, queries, dev)
    print(f"total {time.perf_counter() - t_all:.1f} s")
    kernels = [{k: r[k] for k in ("name", "route", "source", "replaces")}
               | {"launches": launches[r["name"]]}
               | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}
               for r in rows]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
