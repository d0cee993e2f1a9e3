#!/usr/bin/env python3
"""Smoke run of the PyTorch port of LSMGraph on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--edges N]

Phases, each of which must pass (exit code 1 otherwise, with no result
line):

1. Environment: the card's name and power limit, the torch and CUDA
   versions, and the build of every CUDA kernel from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together).
2. The store's kernels against their plain PyTorch versions on the card, at
   the main path's shapes: the presence filter test on 2048 runs of real
   filters and 16384 queries, and the merge permutation of 2**24 and 2**22
   sorted key triples with duplicate keys.  Both must be byte-equal; the
   kernel's time, the plain version's time and the least time the card
   could take (its bound) are printed.
3. The store's write and read path at a realistic scale: Graph500 R-MAT
   scale 22, edgefactor 16 (A/B/C = 0.57/0.19/0.19), each edge carrying a
   Graph500 Kernel 3 SSSP weight (uniform in [0, 1)), streamed through one
   in-memory ``LSMGraph`` with the paper's 20:1 insert:delete mix (a
   repeated delete of an already deleted edge is dropped), no final flush,
   so the active MemGraph, L0, L1 and L2 are all live; then one snapshot
   and ``neighbors_batch`` on 65,536 random vertices plus the 64 of highest
   degree, compared exactly with a numpy last-writer-wins CSR of the whole
   stream.  ``presence_matrix`` and ``merge_perm`` must launch in it.
4. Analytics on a fresh snapshot of that store: ``materialize_csr``, then
   the two segment kernels against their plain versions on its CSR (not
   counted as launches), then PageRank (10 iterations), BFS and SSSP from
   vertex 0, CC, SCAN and merge-free multi-level PageRank (10 iterations),
   each held against an independent numpy/scipy reference.
   ``gather_segsum`` and ``gather_segmin`` must launch in it.
5. A ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and the last line
   ``{"ok": true, "device": {...}}``.

The launch counters are zeroed just before phases 3 and 4 and read just
after each.  The port imports neither ``jax`` nor the JAX package; this
script neither.  There is no CPU fallback: with no CUDA device the script
fails.
"""
from __future__ import annotations

import argparse
import contextlib
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


def lww_csr(src, dst, ins, prop, n: int):
    """numpy last-writer-wins CSR of a whole stream: per (src, dst) key the
    record latest in stream order decides; a live key keeps the prop of its
    last insert.  Returns (voff int64[n+1], dst int64[E], prop float32[E]),
    sorted by (src, dst)."""
    key = (src.astype(np.int64) << 32) | dst.astype(np.int64)
    order = np.argsort(key)
    k = key[order]
    start = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    last = np.maximum.reduceat(order, start)   # latest record of each key
    live = last[ins[last]]
    s = src[live].astype(np.int64)
    return (np.searchsorted(s, np.arange(n + 1)), dst[live].astype(np.int64),
            prop[live].astype(np.float32))


def main_path(dev, cfg, n_edges: int, n_queries: int, seed: int, log=print):
    """Drive the port's write and read path; return its measurements, the
    store and the stream's last-writer-wins CSR."""
    import torch
    from repro_torch import obs
    from repro_torch.core import LSMGraph
    from repro_torch.data import update_stream
    t0 = time.perf_counter()
    src, dst = graph500_edges(n_edges, seed, cfg.vmax.bit_length() - 1)
    # Graph500 Kernel 3: one SSSP weight per edge, uniform in [0, 1).
    weight = np.random.default_rng(seed + 3).random(len(src),
                                                    dtype=np.float32)
    log(f"data: {len(src)} distinct R-MAT edges in "
        f"{time.perf_counter() - t0:.1f} s")
    store = LSMGraph(cfg, device=dev)
    label = store.obs_label
    s_parts, d_parts, i_parts, p_parts = [], [], [], []
    deleted = np.zeros(len(src), bool)
    n_ops = n_dropped = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    # The stream of edge indices: update_stream only slices its arrays, so
    # this is its stream of (src, dst) pairs, with the index of each.
    idx_all = np.arange(len(src))
    for kind, idx, _ in update_stream(idx_all, idx_all, seed=seed,
                                      chunk=cfg.batch_cap):
        if kind == "insert":
            store.insert_edges(src[idx], dst[idx], prop=weight[idx])
            p_parts.append(weight[idx])
        else:
            # update_stream draws deletes with replacement; a second delete
            # of a deleted edge would break the alternating insert/delete
            # history the multi-level views need.  Drop it.
            keep = np.zeros(len(idx), bool)
            keep[np.unique(idx, return_index=True)[1]] = True
            keep &= ~deleted[idx]
            n_dropped += int((~keep).sum())
            idx = idx[keep]
            deleted[idx] = True
            store.delete_edges(src[idx], dst[idx])
            p_parts.append(np.zeros(len(idx), np.float32))
        s_parts.append(src[idx])
        d_parts.append(dst[idx])
        i_parts.append(np.full(len(idx), kind == "insert"))
        n_ops += len(idx)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_ingest = time.perf_counter() - t0
    log(f"stream: {n_dropped} repeated deletes of deleted edges dropped")
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
    t0 = time.perf_counter()
    oracle = lww_csr(s_all, d_all, ins_all, np.concatenate(p_parts),
                     cfg.vmax)
    log(f"oracle: last-writer-wins CSR of {oracle[1].shape[0]} live edges "
        f"in {time.perf_counter() - t0:.1f} s (numpy)")
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
    voff_o, dst_o, _ = oracle
    bad = [int(q) for q, g in zip(queries, out)
           if not np.array_equal(g, dst_o[voff_o[q]:voff_o[q + 1]])]
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
    return dict(store=store, query_vertices=queries, oracle=oracle,
                records=n_ops, deletes_dropped=n_dropped, ingest_s=t_ingest,
                apply_s=apply_s, flush_s=flush.sum, compaction_s=comp_s,
                flushes=flushes, compactions=compactions, level_sizes=sizes,
                runs=runs, spine_ms=t_spine * 1e3,
                resolve_ms_per_chunk=resolve_ms, queries=len(queries),
                peak_gib=peak)


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


# ------------------------------------------------------------------ phase 4
SEG_RTOL, SEG_ATOL = 1e-5, 1e-4   # tests/test_kernels.py's segsum tolerance
# float32 rounding budgets against float64 references (unit roundoff
# u = 6e-8).  A sum's error is at most its longest chain of additions times
# u times the sum of |terms|.  The kernel adds at most 5 + 8 values inside a
# warp range plus one atomic per 256-edge range, about 400 at the hub
# (~100,000 edges), and the multi-level sum adds one partial per run,
# about 2,000 at the hub: 2,000 x 6e-8 = 1.2e-4 for the worst vertex, so a
# relative L1 bound of 1e-4 over all vertices, which low-degree vertices
# dominate, leaves a wide margin.  SCAN's weight sums have positive terms:
# a relative bound of 1e-4 holds for chains up to ~1,600.  SSSP adds one
# float32 weight per hop, each rounded by at most half an ulp (2.4e-7 at
# distances below 4): 1e-4 covers paths of over 400 hops.
PR_REL_L1 = 1e-4
SSSP_ATOL = 1e-4
WSUM_RTOL = 1e-4


def _pos_zero(t):
    """-0.0 -> +0.0 (IEEE: -0.0 + 0.0 == +0.0), for byte comparisons."""
    return t + 0.0


def check_segment_kernels(view, seed):
    """gather_segsum and gather_segmin against their plain versions on the
    card, at the materialized CSR's shapes (its dst and seg_id, n_out = V).

    segsum's inputs are integers of magnitude <= 2 (wt in {1, -1, 0, 2},
    x in [-2, 2]), so every float32 partial sum is an integer below 2**24,
    exact in any order of the kernel's atomics: the kernel must then meet
    rtol 1e-5 / atol 1e-4 (tests/test_kernels.py), and in fact equals the
    plain version.  segmin runs on the SSSP weights and x uniform in
    [0, 10); a min is exact in any order, so it must be byte-equal."""
    import torch
    from repro_torch.kernels import segment_reduce as sr
    dev, n = view.dst.device, view.n_vertices
    dst, seg, e = view.dst, view.seg_ids(), view.dst.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    choice = torch.tensor([1.0, -1.0, 0.0, 2.0], device=dev)
    wt_sum = choice[torch.randint(0, 4, (e,), generator=gen, device=dev)]
    x_sum = torch.randint(-2, 3, (n,), generator=gen, device=dev).float()
    x_min = torch.rand((n,), generator=gen, device=dev) * 10.0
    wt_min = view.prop
    # Bytes: dst, seg_id, wt read once (12 an edge), x read once and y
    # written once (8 a vertex); one multiply-add or add-min an edge.
    t_bound, by = bound(12 * e + 8 * n, 2 * e)
    rows = []
    for name, wt, x in (("gather_segsum", wt_sum, x_sum),
                        ("gather_segmin", wt_min, x_min)):
        kern = getattr(sr, f"{name}_cuda")
        plain = getattr(sr, f"{name}_ref")
        got = kern(dst, seg, wt, x, n)
        want = plain(dst, seg, wt, x, n)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if n else 0.0
        if name == "gather_segsum":
            if not torch.allclose(got, want, rtol=SEG_RTOL, atol=SEG_ATOL):
                raise AssertionError(f"{name} differs from plain: {err}")
            verdict = f"within rtol {SEG_RTOL} / atol {SEG_ATOL} of plain"
            csr = torch.sparse_csr_tensor(view.voff, dst, wt, size=(n, n),
                                          check_invariants=False)
            library = time_ms(lambda: torch.mv(csr, x))
        else:
            if not torch.equal(_pos_zero(got), _pos_zero(want)):
                raise AssertionError(f"{name} differs from plain: {err}")
            verdict = "byte-equal to plain"
            library = None
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/segment_reduce.cu",
            replaces=("src/repro/kernels/segment_reduce.py:57"
                      if name == "gather_segsum" else
                      "src/repro/kernels/segment_reduce.py:114"),
            max_abs_err=err, verdict=verdict,
            ms=time_ms(lambda: kern(dst, seg, wt, x, n)),
            plain_ms=time_ms(lambda: plain(dst, seg, wt, x, n), iters=3,
                             warmup=1),
            bound_ms=t_bound, bound_by=by, library_ms=library,
            shape=f"E={e} edges, n_out={n}"))
    return rows


@contextlib.contextmanager
def _uncounted():
    """Launches inside the block do not count: the counters are put back
    as they were on entry."""
    from repro_torch.kernels import ops
    saved = ops.launch_counts()
    try:
        yield
    finally:
        for name, fn in ops.KERNELS.items():
            fn.launches = saved[name]


def _reversed_bfs(src_o, dst_o, n, source):
    """numpy level-synchronous BFS over reversed edges: the hops from each
    vertex to ``source`` along stored edges (-1: none)."""
    dist = np.full(n, -1, np.int64)
    dist[source] = 0
    frontier = np.zeros(n, bool)
    frontier[source] = True
    level = 0
    while True:
        cand = np.unique(src_o[frontier[dst_o]])
        cand = cand[dist[cand] < 0]
        if not len(cand):
            return dist
        level += 1
        dist[cand] = level
        frontier[:] = False
        frontier[cand] = True


def analytics_path(dev, store, oracle, seed, log=print, check=None):
    """Drive the port's analytics path on a fresh snapshot and hold each
    result against an independent reference.  ``check(view)`` runs on the
    materialized CSR, outside the launch counts."""
    import torch
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.analytics import (bfs, cc, materialize_csr,
                                       multilevel_pagerank, multilevel_views,
                                       pagerank, scan_stats, sssp)
    from repro_torch.kernels import ops
    n = store.cfg.vmax
    cuda = dev.type == "cuda"
    steps, results = {}, {}

    def step(name, fn):
        before = ops.launch_counts()
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        after = ops.launch_counts()
        launched = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        steps[name] = dict(wall_s=wall, launches=launched)
        results[name] = out
        return out

    snap = store.snapshot()
    try:
        view = step("materialize_csr", lambda: materialize_csr(snap, n))
        rows = []
        if check is not None:
            with _uncounted():
                rows = check(view)
        step("pagerank", lambda: pagerank(view, iters=10))
        step("bfs", lambda: bfs(view, 0))
        step("sssp", lambda: sssp(view, 0))
        step("cc", lambda: cc(view))
        step("scan_stats", lambda: scan_stats(view))
        views = step("multilevel_views", lambda: multilevel_views(snap))
        step("multilevel_pagerank", lambda: multilevel_pagerank(
            views, n_out=n, iters=10))
        n_runs = len(views)
    finally:
        snap.release()
    for name in ("bfs", "sssp", "cc"):   # one segmin launch an iteration
        steps[name]["iterations"] = sum(steps[name]["launches"].values())
    steps["pagerank"]["iterations"] = 10
    steps["multilevel_pagerank"]["iterations"] = 10
    for name, st in steps.items():
        log(f"analytics {name}: {st['wall_s'] * 1e3:.1f} ms (host clock, "
            f"ends in a synchronise), iterations "
            f"{st.get('iterations', '-')}, launches {st['launches']}")

    # ---- independent references (numpy / scipy, float64 where it sums)
    t0 = time.perf_counter()
    voff_o, dst_o, prop_o = oracle
    deg_o = np.diff(voff_o)
    src_o = np.repeat(np.arange(n), deg_o)
    e_o = len(dst_o)
    got = {k: v.cpu().numpy() for k, v in zip(
        ("voff", "dst", "prop"), (view.voff, view.dst, view.prop))}
    for k, want in (("voff", voff_o.astype(np.int32)),
                    ("dst", dst_o.astype(np.int32)), ("prop", prop_o)):
        if got[k].dtype != want.dtype or not np.array_equal(got[k], want):
            raise AssertionError(f"materialized CSR {k} differs from the "
                                 f"last-writer-wins oracle")
    log(f"check materialize_csr: voff, dst, prop byte-equal to the numpy "
        f"last-writer-wins CSR ({e_o} edges over {n_runs} runs)")

    a = sp.csr_matrix((np.ones(e_o), dst_o, voff_o), shape=(n, n))
    x = np.full(n, 1.0 / n)
    for _ in range(10):
        y = a @ (x / np.maximum(deg_o, 1))
        x = 0.15 / n + 0.85 * (y + x[deg_o == 0].sum() / n)
    pr = results["pagerank"].double().cpu().numpy()
    rel = np.abs(pr - x).sum() / np.abs(x).sum()
    if not rel <= PR_REL_L1:
        raise AssertionError(f"pagerank: relative L1 {rel:.3e} > "
                             f"{PR_REL_L1}")
    log(f"check pagerank: relative L1 {rel:.3e} against float64 scipy "
        f"power iteration (bound {PR_REL_L1})")

    hops = _reversed_bfs(src_o, dst_o, n, 0)
    d_bfs = results["bfs"].cpu().numpy()
    want = np.where(hops >= 0, hops, 3.0e38).astype(np.float32)
    if not np.array_equal(d_bfs, want):
        raise AssertionError(f"bfs: {(d_bfs != want).sum()} distances "
                             f"differ from the numpy BFS")
    log(f"check bfs: equal to numpy level-synchronous BFS on the reversed "
        f"CSR ({(hops >= 0).sum()} vertices reach 0, depth {hops.max()})")

    rev = sp.csr_matrix((prop_o.astype(np.float64), (dst_o, src_o)),
                        shape=(n, n))
    d64 = dijkstra(rev, indices=0)
    d_sp = results["sssp"].double().cpu().numpy()
    reach = np.isfinite(d64)
    if not np.array_equal(reach, d_sp < 1e38):
        raise AssertionError("sssp: reachable set differs from dijkstra")
    err = np.abs(d_sp[reach] - d64[reach]).max() if reach.any() else 0.0
    if not err <= SSSP_ATOL:
        raise AssertionError(f"sssp: max error {err:.3e} > {SSSP_ATOL}")
    log(f"check sssp: reachable set equal to scipy dijkstra (float64) on "
        f"the reversed CSR, max abs error {err:.3e} (bound {SSSP_ATOL}, "
        f"largest distance {d64[reach].max():.4f})")

    lab = results["cc"]
    if not torch.equal(lab, cc(view, use_pallas=False)):
        raise AssertionError("cc differs from its plain version")
    lab = lab.cpu().numpy().astype(np.int64)
    if not ((lab[src_o] <= lab[dst_o]).all()
            and (lab <= np.arange(n)).all()):
        raise AssertionError("cc labels are not a min-label fixpoint")
    log(f"check cc: byte-equal to the plain version on the card, and a "
        f"min-label fixpoint over the oracle CSR "
        f"({len(np.unique(lab))} labels)")

    deg, wsum = (t.double().cpu().numpy() for t in results["scan_stats"])
    w64 = np.bincount(src_o, weights=prop_o.astype(np.float64),
                      minlength=n)
    wrel = (np.abs(wsum - w64) / np.maximum(w64, 1e-30))[w64 > 0]
    if not np.array_equal(deg, deg_o) or not (wrel <= WSUM_RTOL).all():
        raise AssertionError(f"scan_stats: degrees equal "
                             f"{np.array_equal(deg, deg_o)}, wsum max "
                             f"relative error {wrel.max():.3e}")
    log(f"check scan_stats: degrees equal to the oracle's, wsum max "
        f"relative error {wrel.max() if len(wrel) else 0.0:.3e} against "
        f"float64 (bound {WSUM_RTOL})")

    ml = results["multilevel_pagerank"].double().cpu().numpy()
    mrel = np.abs(ml - pr).sum() / np.abs(pr).sum()
    if not mrel <= PR_REL_L1:
        raise AssertionError(f"multilevel_pagerank: relative L1 {mrel:.3e}"
                             f" from merged > {PR_REL_L1}")
    log(f"check multilevel_pagerank: relative L1 {mrel:.3e} from the "
        f"merged PageRank over {n_runs} runs (bound {PR_REL_L1}); "
        f"references took {time.perf_counter() - t0:.1f} s")
    launches = {}
    for st in steps.values():
        for k, v in st["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return dict(steps={k: {"wall_ms": round(v["wall_s"] * 1e3, 3),
                           "iterations": v.get("iterations"),
                           "launches": v["launches"]}
                       for k, v in steps.items()},
                launches=launches, rows=rows, runs=n_runs, edges=e_o)


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
    launches = {"store": ops.launch_counts()}
    print(f"main path (store) launches: {launches['store']}")
    need_launches(launches["store"], ("presence_matrix", "merge_perm"),
                  "the store's path")
    store, queries = stats.pop("store"), stats.pop("query_vertices")
    oracle = stats.pop("oracle")
    print(f"main path (store): {json.dumps(stats)}")
    profile_read(store, queries, dev)

    ops.reset_launches()
    t0 = time.perf_counter()
    an = analytics_path(dev, store, oracle, args.seed,
                        check=lambda view: check_segment_kernels(
                            view, args.seed))
    launches["analytics"] = ops.launch_counts()
    print(f"main path (analytics) launches: {launches['analytics']}")
    need_launches(launches["analytics"], ("gather_segsum", "gather_segmin"),
                  "the analytics path")
    for r in an["rows"]:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.3f} ms")
        print(f"kernel {r['name']} ({r['shape']}): {r['verdict']} (max abs "
              f"err {r['max_abs_err']}); {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {lib} [{smi}]")
    rows += an.pop("rows")
    print(f"main path (analytics): {json.dumps(an)}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"total {time.perf_counter() - t_all:.1f} s")
    phase_of = {"presence_matrix": "store", "merge_perm": "store",
                "gather_segsum": "analytics", "gather_segmin": "analytics"}
    kernels = [{k: r[k] for k in ("name", "route", "source", "replaces")}
               | {"launches": launches[phase_of[r["name"]]][r["name"]]}
               | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}
               for r in rows]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def need_launches(counts, names, path: str) -> None:
    missing = [k for k in names if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on {path}: {missing}")


if __name__ == "__main__":
    sys.exit(main())
