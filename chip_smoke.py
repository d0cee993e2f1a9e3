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
   filters and 16384 queries, and the merge-path permutation of 2**24 and
   2**22 sorted key triples with duplicate keys.  Both must be byte-equal;
   the kernel's time (CUDA events, and device time by ``torch.profiler``),
   the plain version's time and the least time the card could take (its
   bound) are printed, and for presence the device time with every row
   cut to FILTER_MIN_BITS.
3. The store's write and read path at a realistic scale: Graph500 R-MAT
   scale 22, edgefactor 16 (A/B/C = 0.57/0.19/0.19), each edge carrying a
   Graph500 Kernel 3 SSSP weight (uniform in [0, 1)), streamed through one
   in-memory ``LSMGraph`` with the paper's 20:1 insert:delete mix (a
   repeated delete of an already deleted edge is dropped), no final flush,
   so the active MemGraph, L0, L1 and L2 are all live; then one snapshot
   and ``neighbors_batch`` on 65,536 random vertices plus the 64 of highest
   degree, compared exactly with a numpy last-writer-wins CSR of the whole
   stream.  ``presence_matrix`` must launch in it, and ``merge_pairs``
   once a round of the spine's tournament (one more round for the sealed
   MemGraph handoff when one is live); ``merge_perm`` must not launch.
   Then, outside the launch counts, a profiled second read (spine rebuilt)
   and the batched tournament over the store's own run streams, laid end
   to end as the spine build lays them, byte-equal to its plain version.
4. Analytics on a fresh snapshot of that store: ``materialize_csr``, then
   the two segment kernels against their plain versions on its CSR (not
   counted as launches), then PageRank (10 iterations), BFS and SSSP from
   vertex 0, CC, SCAN and merge-free multi-level PageRank (10 iterations),
   each held against an independent numpy/scipy reference.  The multi-run
   segment sum is held against its plain version on every run view laid
   end to end (not counted), and must launch once a sweep in multi-level
   PageRank (11 launches).  ``gather_segsum``, ``gather_segmin`` and
   ``gather_segsum_runs`` must launch in it; on the full stream at seed 0
   12, 35 and 11 times, with BFS, SSSP and CC taking 6, 23 and 6
   iterations.  Each single-run kernel is timed by CUDA events, by
   ``torch.profiler`` (all its kernels, and the reduction alone) and on two
   data probes (dst all 0, dst = seg_id).
5. Paper Fig 16 on that store: ``neighbors_batch`` of phase 3's queries
   with the multi-level index off (the read spine probes every run), then
   the legacy concat-then-lexsort read (``LSMG_READ_TOURNAMENT_K=0``) with
   the index on and off, each equal to the oracle; then the per-run
   no-index probe on a fresh snapshot: ``run_lookup_batch(use_pallas=True)``
   on every run, byte-equal to its plain version, naming the slice the
   multi-level index names on every L1+ run and never finding a vertex its
   filter rules out on L0.  ``batched_searchsorted`` must launch once a run.
   Then the same probe over every run at once (``csr.runs_lookup_batch``),
   byte-equal to the per-run pass and to its plain version, with exactly
   one launch of ``batched_searchsorted_runs``; both walls are printed
   beside the index's lookup, with the one-launch pass's peak device
   memory.  Both search kernels are then timed on the phase's queries: the
   single-run one on the largest run (504,073 keys at seed 0), the
   multi-run one on every run.
6. Attention at the width of Qwen2-7B (28 query heads, 4 kv heads, head
   dim 128) at 4,096 tokens in bfloat16, causal and not, and at
   bench_kernels.py's float32 shape, through ``ops.attention(use_pallas=
   True)``; each held against the plain version on the inputs upcast to
   float32.  ``flash_attention`` must launch in it: the bfloat16 calls on
   the tensor-core kernel, the float32 call on the CUDA-core one.
7. Durable and concurrent, at the same scale: phase 3's stream (not
   generated again) and ``StoreConfig`` through ``open_store`` on the card
   (``wal_sync="batch"``, in a fresh temporary directory, removed at the
   end; the phase first checks the free disk space) wrapped by
   ``ConcurrentLSMGraph``, while a reader thread pins a snapshot each time
   the ingest passes another eighth of the stream and reads 4,096 of phase
   3's queries, each read equal to the oracle of the records below its
   snapshot's τ.  Then ``close()`` with no final flush, ``open_store`` of
   the directory (L1 runs under L2 runs, a WAL tail replayed), the read of
   phase 3's queries equal to the oracle with ``presence_matrix`` and
   ``merge_pairs`` launched (one a round) and no ``merge_perm``, every run
   evicted and the same read cold through the prefetch path, and
   ``scrub_once()`` finding nothing.  It prints the durable ingest rate
   beside phase 3's, the bytes written, the recovery, the cold read and
   the peak device memory.
8. Sharded, durable, at the same scale: phase 3's stream and ``StoreConfig``
   through ``open_sharded_store`` with 4 shards on the card
   (``wal_sync="batch"``; each shard provisioned like the whole store, as
   the service provisions it, so the MemGraph budget is 4x phase 3's), in
   a fresh temporary directory (free disk checked first, removed at the
   end), with a ``CompactionScheduler`` running: routed batches of phase
   3's sizes and order, every 64th and the last acked, no final flush.
   Then ``ShardedSnapshot.neighbors_batch`` of phase 3's queries with a
   degraded report: equal to the oracle, the report clean,
   ``presence_matrix`` launched, ``merge_pairs`` exactly once a round of
   every shard's spine tournament summed over the shards (the pool's
   threads launch them), ``merge_perm`` never; ``query_edges_batch`` of
   65,536 pairs (half of them edges) equal to the oracle; every shard
   "ok" in ``health_report()`` with its physical write amplification;
   then ``close()``, ``open_sharded_store`` again (every shard recovers in
   parallel, a WAL tail replayed) and the same read, equal again.
9. The graph service on the card, in this process, at its own default
   size (2,000 vertices, 30,000 edges): ``graph_service.main`` once
   durable on one store with multi-level PageRank, a metrics report and a
   trace, and once sharded (4 shards), durable, with the chaos phase and a
   metrics report.  The chaos phase must restore the edge set; both
   reports must have the schema and families ``tools/obs_smoke.py``
   checks (shard and compaction too for the sharded one); the trace must
   hold a span; run 1 must launch ``presence_matrix``, ``merge_pairs`` and
   ``gather_segsum_runs``, run 2 ``presence_matrix`` and ``merge_pairs``.
10. A ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and the last
    line ``{"ok": true, "device": {...}}``.

The launch counters are zeroed just before phases 3 to 9 (each run of
phase 9, and each read of phase 8) and read just after each.  The port imports neither ``jax`` nor the JAX package; this
script neither.  There is no CPU fallback: with no CUDA device the script
fails.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
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
# H100 SXM dense bf16 tensor-core peak (NVIDIA H100 data sheet, without
# sparsity): the bound an attention kernel is held to.
BF16_TC_FLOPS = 989e12
SCALE = 22
EDGEFACTOR = 16
# Qwen2-7B's attention (src/repro/configs/qwen2_7b.py: 28 query heads, 4 kv
# heads, head_dim 128), at the sequence length of the train_4k shape of
# src/repro/configs/base.py.
QWEN_HQ, QWEN_HKV, QWEN_D, QWEN_SEQ = 28, 4, 128, 4096
# bench_kernels.py's full attention shape (B, Hq, Hkv, S, D), in float32.
BENCH_ATTN = (1, 8, 2, 512, 128)
ATT_F32_TOL = dict(rtol=1e-3, atol=2e-3)    # tests/test_kernels.py
ATT_BF16_ATOL = 2e-2                          # 8 significant bits out
# At 4,096 keys |o| is about 0.02, so atol 2e-2 alone cannot fail a wrong
# kernel.  bfloat16 rounds the output by at most 2^-8 of its value; the
# limit is twice that plus a floor for float32 summation over the keys.
ATT_BF16_REL, ATT_BF16_FLOOR = 2.0 ** -7, 1e-4


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


def device_ms(fn, kernel: str = "", iters: int = 20, by_kernel=None):
    """Mean device time a call of ``fn`` spends in the kernels whose name
    holds ``kernel`` (in all its kernels by default), by ``torch.profiler``
    over ``iters`` calls: the device's work alone, where CUDA events around
    back-to-back calls would time the host's dispatch of calls shorter
    than their Python.  ``by_kernel``, a dict, receives each counted
    kernel's (launches a call, device ms a call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # The profiler can drop a kernel's records (seen on the H100: 19 of 20
    # launches of one kernel reported; once, all 50 launches of a 6 µs
    # kernel in one profile, where earlier profiles of the process had seen
    # it), so a profile that sees no such kernel is taken again, up to
    # three in all, and each kernel counts as its mean time a launch times
    # its launches a call, rounded.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if any(e.device_type == torch.autograd.DeviceType.CUDA and
               kernel in e.key and e.count for e in events):
            break
    total, n = 0.0, 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                kernel in e.key and e.count:
            t = getattr(e, "self_device_time_total", None)
            t = e.self_cuda_time_total if t is None else t
            per_call = max(round(e.count / iters), 1)
            total += t / e.count * per_call
            n += e.count
            if by_kernel is not None:
                by_kernel[e.key[:60]] = (e.count / iters,
                                         t / e.count * per_call / 1e3)
    if n == 0:
        raise AssertionError(f"the profiler saw no kernel named {kernel!r}")
    return total / 1e3


def bound(nbytes: float, nops: float, ops_per_s: float = INT32_OPS_PER_S):
    """Least time the card could take: bytes over the memory rate or
    operations over the peak rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 2
def presence_inputs(dev, rng, b: int = 16384):
    """Ragged filters (words, offs, masks) of two L0-sized runs and 2046
    segment-sized runs, as the main path has, and ``b`` int32 queries, half
    of them keys of the first eight runs."""
    import torch
    from repro_torch.core import filters
    from repro_torch.core.store import _stack_presence
    sizes = [600_000] * 2 + [4_000] * 2046
    runs, keysets = [], []
    for n in sizes:
        keys = np.unique(rng.integers(0, 1 << SCALE, n))
        keysets.append(keys)
        runs.append((SimpleNamespace(presence=filters.from_vkeys(keys)), 0))
    words, offs, masks = _stack_presence(runs, dev)
    q = np.concatenate([rng.choice(np.concatenate(keysets[:8]), b // 2),
                        rng.integers(0, 1 << SCALE, b - b // 2)])
    return words, offs, masks, torch.from_numpy(q.astype(np.int32)).to(dev)


def check_presence(dev, rng):
    import torch
    from repro_torch.core import filters
    from repro_torch.kernels import presence
    words, offs, masks, queries = presence_inputs(dev, rng)
    b = queries.shape[0]
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

    def kern(m=masks):
        return presence.presence_matrix_cuda(words, offs, m, queries)

    # The probe: every row cut to FILTER_MIN_BITS (all probes of a row in
    # its first 8 words), which leaves the hashing, the stores and the
    # staging of 8 words a run.
    min_masks = torch.full_like(masks, filters.FILTER_MIN_BITS - 1)
    return dict(
        name="presence_matrix", route="cuda",
        source="src/repro_torch/csrc/presence.cu",
        replaces="src/repro/kernels/presence.py:85",
        max_abs_err=err,
        ms=time_ms(kern, iters=50),
        device_ms=device_ms(kern, "presence", iters=50),
        probe_min_bits_ms=device_ms(lambda: kern(min_masks), "presence",
                                    iters=50),
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


def time_ms_fresh(fn, make, iters: int = 5) -> float:
    """Mean device time of ``fn(make())`` by CUDA events around ``fn``
    alone, for a ``fn`` that overwrites its inputs: ``make`` gives fresh
    ones before each call, outside the timed window."""
    import torch
    fn(make())
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        x = make()
        torch.cuda.synchronize()
        t0.record()
        fn(x)
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
        del x
    return total / iters


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
        device_ms=device_ms(lambda: merge.merge_perm_cuda(a, b, na, nb),
                            kernel="perm_"),
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


def _spine_rounds(state):
    """(sealed runs, rounds of the spine's tournament) of a state: one
    round of merge_pairs a halving of the runs, and one more when a sealed
    MemGraph rides the spine."""
    bad = {r.fid for r in state.degraded}
    runs = sum(1 for lvl in state.levels for rf in lvl
               if rf.nv > 0 and rf.fid not in bad)
    handoff = state.mem_full is not None and int(state.mem_full.ne) != 0
    return runs, max(runs - 1, 0).bit_length() + int(handoff and runs > 0)


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
    p_all = np.concatenate(p_parts)
    t0 = time.perf_counter()
    oracle = lww_csr(s_all, d_all, ins_all, p_all, cfg.vmax)
    log(f"oracle: last-writer-wins CSR of {oracle[1].shape[0]} live edges "
        f"in {time.perf_counter() - t0:.1f} s (numpy)")
    deg = np.bincount(s_all[ins_all], minlength=cfg.vmax)
    top = np.argsort(-deg, kind="stable")[:64]
    queries = np.unique(np.concatenate([
        rng.choice(cfg.vmax, n_queries, replace=False), top]))
    spine_runs, spine_rounds = _spine_rounds(store._state)
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
    n_out = check_oracle(queries, out, oracle, "the read")
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
                runs=runs, spine_ms=t_spine * 1e3, spine_runs=spine_runs,
                spine_rounds=spine_rounds,
                resolve_ms_per_chunk=resolve_ms, queries=len(queries),
                peak_gib=peak,
                stream=dict(src=s_all, dst=d_all, ins=ins_all, prop=p_all,
                            sizes=[len(x) for x in s_parts]))


def check_merge_pairs(store, log=print):
    """The batched tournament over the store's own run streams, laid end to
    end as the spine build lays them (L0, then L1 and deeper), against its
    plain version on the same buffers and round tables: every column
    byte-equal.  Times: CUDA events around the whole tournament (the round
    kernels' enqueue included) and the round kernels' device time by
    ``torch.profiler``, each call on fresh copies of the buffers, which the
    kernel overwrites.  Bound: every record's keys and payload read once
    and written once, the least a k-way merge moves."""
    import torch
    from repro_torch.core.store import _spine_run_streams
    from repro_torch.kernels import merge
    runs = [(rf, -1) for rf in store.levels[0] if rf.nv > 0] + [
        (rf, col) for col, lvl in enumerate(store.levels[1:])
        for rf in lvl if rf.nv > 0]
    cols, caps = _spine_run_streams(runs)
    plan = merge.merge_plan(caps)

    def fresh():
        return tuple(c.clone() for c in cols)

    t0 = time.perf_counter()
    want = merge.merge_pairs_plain(cols, plan)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = merge.merge_pairs_cuda(fresh(), plan)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"merge_pairs column {i} differs from "
                                 f"plain")
    del got, want
    n = plan.n
    rec = sum(c.element_size() for c in cols)
    # One 3-key comparison (~5 ops) a record a round.
    t_bound, by = bound(2 * rec * n, 5 * n * len(plan.rounds))
    ms = time_ms_fresh(lambda c: merge.merge_pairs_cuda(c, plan), fresh)
    dev_ms = device_ms(lambda: merge.merge_pairs_cuda(fresh(), plan),
                       kernel="pairs_", iters=5)
    log(f"merge_pairs: {len(caps)} run streams, {n} records of {rec} "
        f"bytes, {len(plan.rounds)} rounds; a round's bound (every record "
        f"read and written once) {t_bound:.4f} ms, device "
        f"{dev_ms / len(plan.rounds):.4f} ms a round")
    return dict(
        name="merge_pairs", route="cuda",
        source="src/repro_torch/csrc/merge_perm.cu",
        replaces="src/repro/kernels/merge.py:199",
        max_abs_err=0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=t_bound, bound_by=by, library_ms=None,
        shape=(f"{len(caps)} run streams laid end to end, {n} records, "
               f"{len(plan.rounds)} rounds"))


def check_oracle(queries, out, oracle, what: str) -> int:
    """Fail unless every adjacency list equals the last-writer-wins CSR's;
    return the number of edges read."""
    voff_o, dst_o, _ = oracle
    bad = [int(q) for q, g in zip(queries, out)
           if not np.array_equal(g, dst_o[voff_o[q]:voff_o[q + 1]])]
    if bad:
        raise AssertionError(
            f"{what}: {len(bad)} of {len(queries)} adjacency lists differ "
            f"from the last-writer-wins oracle, first {bad[:5]}")
    return sum(len(g) for g in out)


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
# (~100,000 edges), and the multi-level sum adds one atomic partial per
# run, about 2,000 at the hub: 2,000 x 6e-8 = 1.2e-4 for the worst vertex,
# so a relative L1 bound of 1e-4 over all vertices, which low-degree
# vertices dominate, leaves a wide margin.  SCAN's weight sums have
# positive terms: a relative bound of 1e-4 holds for chains up to ~1,600.
# SSSP adds one float32 weight per hop, each rounded by at most half an ulp
# (2.4e-7 at distances below 4): 1e-4 covers paths of over 400 hops.
PR_REL_L1 = 1e-4
SSSP_ATOL = 1e-4
WSUM_RTOL = 1e-4
# The analytics path's launches and iterations on the full scale-22 stream
# at seed 0, as measured on an H100.  They follow from the graph alone: a
# kernel that computes the same function must not move them.
SEED0_ANALYTICS = dict(
    launches={"gather_segsum": 12, "gather_segmin": 35,
              "gather_segsum_runs": 11},
    iterations={"bfs": 6, "sssp": 23, "cc": 6})


def _pos_zero(t):
    """-0.0 -> +0.0 (IEEE: -0.0 + 0.0 == +0.0), for byte comparisons."""
    return t + 0.0


# The profiler's name of the reduction kernel of the single-run segment
# kernels, without the fill kernel that runs before it.
SEG_REDUCE_KERNEL = "seg_reduce_kernel"


def segment_times(call, dst, seg, wt, x, n):
    """Times of a segment-kernel call ``call(dst, seg, wt, x, n)``: CUDA
    events around back-to-back calls (``ms``), device time of all its
    kernels (``device_ms``) and of the reduction kernel alone
    (``reduce_ms``), both by ``torch.profiler``; and the reduction alone on
    two data probes that change data, not code: dst all zeros (every gather
    hits one line: ``probe_zero_ms``) and dst = seg_id (near-sequential
    gathers: ``probe_seq_ms``).  The probes split the gather's cost from
    the streaming of dst, seg_id and wt and the writes of y."""
    import torch

    def at(d):
        return lambda: call(d, seg, wt, x, n)

    zero = torch.zeros_like(dst)
    seq = seg.clamp(0, x.shape[0] - 1)
    kernels = {}
    return dict(ms=time_ms(at(dst)),
                device_ms=device_ms(at(dst), by_kernel=kernels),
                device_kernels=kernels,
                reduce_ms=device_ms(at(dst), SEG_REDUCE_KERNEL),
                probe_zero_ms=device_ms(at(zero), SEG_REDUCE_KERNEL),
                probe_seq_ms=device_ms(at(seq), SEG_REDUCE_KERNEL))


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
            **segment_times(kern, dst, seg, wt, x, n),
            plain_ms=time_ms(lambda: plain(dst, seg, wt, x, n), iters=3,
                             warmup=1),
            bound_ms=t_bound, bound_by=by, library_ms=library,
            shape=f"E={e} edges, n_out={n}"))
    return rows


def check_segsum_runs(views, n, seed):
    """gather_segsum_runs against its plain version on the card, at the
    multi-level shape: every run view's records laid end to end, n_out = V.
    The views' weights are +1, -1 and 0 and x holds integers in [-2, 2], so
    every float32 partial sum is an exact integer: the kernel must meet
    SEG_RTOL / SEG_ATOL and in fact equals the plain version."""
    import torch
    from repro_torch.analytics import run_batch
    from repro_torch.kernels import segment_reduce as sr
    batch = run_batch(views)
    dst, seg, wt = batch.dst, batch.src, batch.wt
    dev, e = dst.device, dst.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 17)
    x = torch.randint(-2, 3, (n,), generator=gen, device=dev).float()

    def kern():
        return sr.gather_segsum_runs_cuda(dst, seg, wt, x, n)

    def plain():
        return sr.gather_segsum_runs_ref(dst, seg, wt, x, n)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if n else 0.0
    if not torch.allclose(got, want, rtol=SEG_RTOL, atol=SEG_ATOL):
        raise AssertionError(f"gather_segsum_runs differs from plain: {err}")
    exact = torch.equal(got, want)
    # One PyTorch call for the same function: a sparse COO product over the
    # records as they are (duplicates summed; the call coalesces them).
    coo = torch.sparse_coo_tensor(torch.stack([seg.long(), dst.long()]), wt,
                                  (n, n), check_invariants=False)
    library = time_ms(lambda: torch.sparse.mm(coo, x[:, None]), iters=3,
                      warmup=1)
    del coo
    # Bytes: dst, seg_id, wt read once (12 a record), x read once and y
    # written once (8 a vertex); one multiply-add a record.
    t_bound, by = bound(12 * e + 8 * n, 2 * e)
    return dict(
        name="gather_segsum_runs", route="cuda",
        source="src/repro_torch/csrc/segment_reduce.cu",
        replaces="src/repro/kernels/segment_reduce.py:57",
        max_abs_err=err,
        verdict=(f"within rtol {SEG_RTOL} / atol {SEG_ATOL} of plain"
                 f"{' (byte-equal)' if exact else ''}"),
        ms=time_ms(kern), device_ms=device_ms(kern),
        plain_ms=time_ms(plain, iters=3, warmup=1),
        bound_ms=t_bound, bound_by=by, library_ms=library,
        shape=f"{len(views)} runs, {e} records end to end, n_out={n}")


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


def analytics_path(dev, store, oracle, seed, log=print, check=None,
                   check_runs=None):
    """Drive the port's analytics path on a fresh snapshot and hold each
    result against an independent reference.  ``check(view)`` runs on the
    materialized CSR and ``check_runs(views)`` on the multi-level views,
    both outside the launch counts."""
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
        if check_runs is not None:
            with _uncounted():
                rows += [check_runs(views)]
        if cuda:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        step("multilevel_pagerank", lambda: multilevel_pagerank(
            views, n_out=n, iters=10))
        added = (torch.cuda.max_memory_allocated(dev) - base if cuda
                 else 0)
        n_runs = len(views)
        n_records = sum(rv.src.shape[0] for rv in views)
    finally:
        snap.release()
    for name in ("bfs", "sssp", "cc"):   # one segmin launch an iteration
        steps[name]["iterations"] = sum(steps[name]["launches"].values())
    steps["pagerank"]["iterations"] = 10
    steps["multilevel_pagerank"]["iterations"] = 10
    ml_launches = steps["multilevel_pagerank"]["launches"]
    if cuda and ml_launches != {"gather_segsum_runs": 11}:
        raise AssertionError(f"multilevel_pagerank launched {ml_launches}, "
                             f"not one gather_segsum_runs a sweep (11)")
    log(f"multilevel_pagerank: {n_records} records of {n_runs} runs laid end"
        f" to end; peak device memory above the views "
        f"{added / 2**30:.3f} GiB")
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
                launches=launches, rows=rows, runs=n_runs, edges=e_o,
                run_records=n_records, multilevel_added_gib=added / 2**30)


# ------------------------------------------------------------------ phase 5
def _timed_read(store, queries, *, index: bool):
    """One fresh snapshot's ``neighbors_batch`` of ``queries`` with the
    multi-level index on or off (toggled on the store's config and put
    back): (adjacency lists, wall seconds ending in a device synchronise,
    read_runs_probed_total per query, read_filter_checked_total per query).
    The first counts runs consulted per resolve chunk; the second counts
    the (run, query) pairs that reach a presence filter."""
    import torch
    from repro_torch import obs
    probes = obs.REGISTRY.counter("read_runs_probed_total",
                                  store=store.obs_label)
    checked = obs.REGISTRY.counter("read_filter_checked_total",
                                   store=store.obs_label)
    p0, c0 = probes.value, checked.value
    snap = store.snapshot()
    saved = store.cfg.use_multilevel_index
    object.__setattr__(store.cfg, "use_multilevel_index", index)
    try:
        if store.device.type == "cuda":
            torch.cuda.synchronize(store.device)
        t0 = time.perf_counter()
        out = snap.neighbors_batch(queries)
        if store.device.type == "cuda":
            torch.cuda.synchronize(store.device)
        wall = time.perf_counter() - t0
    finally:
        object.__setattr__(store.cfg, "use_multilevel_index", saved)
        snap.release()
    return (out, wall, (probes.value - p0) / len(queries),
            (checked.value - c0) / len(queries))


def fig16_path(dev, store, queries, oracle, log=print):
    """Paper Fig 16 on the phase-3 store: the read with the multi-level
    index off, the legacy concat-then-lexsort read (``LSMG_READ_
    TOURNAMENT_K=0``) with the index on and off, each held against the
    last-writer-wins oracle; then the per-run no-index probe, one
    ``run_lookup_batch(use_pallas=True)`` a run, held against its plain
    version, the multi-level index (L1+) and the presence filters (L0)."""
    import torch
    from repro_torch.core import csr, index as mlindex, store as store_mod
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    res = {}
    out, wall, ppq, cpq = _timed_read(store, queries, index=False)
    check_oracle(queries, out, oracle, "no-index spine read")
    res["spine_no_index"] = dict(wall_ms=wall * 1e3, probes_per_query=ppq,
                                 filter_checked_per_query=cpq)
    log(f"fig16 spine read, index off: {len(queries)} queries equal to the "
        f"oracle in {wall * 1e3:.1f} ms; per query {ppq:.4f} runs probed, "
        f"{cpq:.1f} (run, query) pairs filter-checked")
    saved = store_mod._READ_TOURNAMENT_MAX_K
    store_mod._READ_TOURNAMENT_MAX_K = 0
    try:
        for index in (True, False):
            out, wall, ppq, cpq = _timed_read(store, queries, index=index)
            what = f"legacy read, index {'on' if index else 'off'}"
            check_oracle(queries, out, oracle, what)
            res[f"legacy_index_{'on' if index else 'off'}"] = dict(
                wall_ms=wall * 1e3, probes_per_query=ppq,
                filter_checked_per_query=cpq)
            log(f"fig16 {what}: {len(queries)} queries equal to the oracle in "
                f"{wall * 1e3:.1f} ms; per query {ppq:.4f} runs probed, "
                f"{cpq:.1f} (run, query) pairs filter-checked")
    finally:
        store_mod._READ_TOURNAMENT_MAX_K = saved

    snap = store.snapshot()
    try:
        runs = [(rf, -1) for rf in snap.l0_runs] + [
            (rf, col) for col, lvl in enumerate(snap.level_runs)
            for rf in lvl]
        arrays = [rf.ensure_loaded() for rf, _col in runs]
        u = torch.from_numpy(queries.astype(np.int32)).to(dev)
        sync()
        t0 = time.perf_counter()
        probed = [csr.run_lookup_batch(a, u, use_pallas=True)
                  for a in arrays]
        sync()
        t_probe = time.perf_counter() - t0
        t0 = time.perf_counter()
        _first, _min, lvl_fid, lvl_off = mlindex.lookup_batch(snap.index, u)
        sync()
        t_index = time.perf_counter() - t0
        # (a) plain mismatches, (b) index-found and offset mismatches.
        bad = torch.zeros(3, dtype=torch.int64, device=dev)
        n_found = torch.zeros((), dtype=torch.int64, device=dev)
        l0_bad = 0
        for (rf, col), a, (f, st, en) in zip(runs, arrays, probed):
            f2, st2, en2 = csr.run_lookup_batch(a, u, use_pallas=False)
            bad[0] += (f != f2).sum() + (st != st2).sum() + (en != en2).sum()
            n_found += f.sum()
            if col >= 0:
                named = lvl_fid[:, col] == rf.fid
                bad[1] += (f != named).sum()
                bad[2] += (f & (st != lvl_off[:, col])).sum()
            elif rf.presence is not None:
                # (c) no false negatives: found implies the filter's maybe.
                maybe = rf.presence.might_contain(queries)
                l0_bad += int((f.cpu().numpy() & ~maybe).sum())
        bad = bad.tolist()
    finally:
        snap.release()
    n_l0 = sum(col < 0 for _rf, col in runs)
    if any(bad) or l0_bad:
        raise AssertionError(
            f"per-run probe: {bad[0]} kernel/plain mismatches, {bad[1]} "
            f"found/index mismatches, {bad[2]} offset mismatches (L1+), "
            f"{l0_bad} found but filtered out (L0)")
    # The same probe in one launch over every run laid end to end, held
    # byte-equal to the per-run pass and to its plain version.
    per_run = [torch.stack(col) for col in zip(*probed)]
    del probed
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    t0 = time.perf_counter()
    one = csr.runs_lookup_batch(arrays, u)
    sync()
    t_one = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    plain = csr.runs_lookup_batch(arrays, u, use_pallas=False)
    for what, other in (("the per-run pass", per_run), ("plain", plain)):
        for name, a, b in zip(("found", "start", "end"), one, other):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"one-launch probe: {name} differs "
                                     f"from {what}")
    del one, plain, per_run
    largest = arrays[max(range(len(runs)), key=lambda i: runs[i][0].nv)]
    res["probe"] = dict(runs=len(runs), l0_runs=n_l0,
                        found=int(n_found), probe_ms=t_probe * 1e3,
                        one_launch_ms=t_one * 1e3,
                        one_launch_peak_gib=peak / 2**30,
                        index_lookup_ms=t_index * 1e3,
                        nv_min_median_max=[int(x) for x in np.percentile(
                            [rf.nv for rf, _c in runs], [0, 50, 100])],
                        runs_over_4096_keys=sum(rf.nv > 4096
                                                for rf, _c in runs))
    log(f"fig16 per-run probe: {len(runs)} runs ({n_l0} L0) x {len(queries)}"
        f" queries, {int(n_found)} (vertex, run) pairs found; byte-equal to "
        f"the plain version, found and offsets equal to the multi-level "
        f"index on every L1+ run, no found vertex filtered out on L0")
    log(f"fig16 one-launch probe (csr.runs_lookup_batch): byte-equal to the "
        f"per-run pass and to its plain version; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"fig16 probe pass {t_probe * 1e3:.1f} ms (one launch a run), "
        f"{t_one * 1e3:.2f} ms (one launch for every run), against "
        f"mlindex.lookup_batch {t_index * 1e3:.3f} ms for the same queries "
        f"(host clock, each ending in a synchronise)")
    return res, largest, arrays, u


def check_lookup(run, u):
    """batched_searchsorted against its plain version on the card, on the
    largest run of the probe pass and the phase's queries."""
    import torch
    from repro_torch.kernels import lookup
    keys, nk = run.vkeys, run.nv
    got = lookup.batched_searchsorted_cuda(keys, u, nk)
    want = lookup.batched_searchsorted_ref(keys, u, nk)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"batched_searchsorted differs from plain: {err}")
    n, nq = int(nk), u.shape[0]
    # keys[:n] and the queries read once, the insertion points written once;
    # a bisection step is a compare, a select and an add or shift (~4 ops).
    t_bound, by = bound(4 * n + 8 * nq + 4, 4 * nq * max(n.bit_length(), 1))
    head = keys[:n]

    def kern():
        return lookup.batched_searchsorted_cuda(keys, u, nk)

    def plain():
        return lookup.batched_searchsorted_ref(keys, u, nk)

    def lib():
        return torch.searchsorted(head, u)

    # The kernel runs for a few µs, less than its wrapper's Python: CUDA
    # events around back-to-back calls time the host's dispatch, the
    # profiler the device's work.  The row's times are by events, each
    # with its device time beside it.
    times = {k: (time_ms(f, iters=50), device_ms(f, "searchsorted", iters=50))
             for k, f in (("kern", kern), ("plain", plain), ("lib", lib))}
    return dict(
        name="batched_searchsorted", route="cuda",
        source="src/repro_torch/csrc/lookup.cu",
        replaces="src/repro/kernels/lookup.py:48",
        max_abs_err=err, verdict="byte-equal to plain",
        ms=times["kern"][0], device_ms=times["kern"][1],
        plain_ms=times["plain"][0], bound_ms=t_bound, bound_by=by,
        library_ms=times["lib"][0],
        shape=f"n_keys={n} (cap {keys.shape[0]}), nq={nq}",
        note="device ms a call (torch.profiler): kernel "
             f"{times['kern'][1]:.4f}, plain {times['plain'][1]:.4f}, "
             f"torch.searchsorted {times['lib'][1]:.4f}")


def check_lookup_runs(arrays, u):
    """batched_searchsorted_runs against its plain version on every run of
    the probe pass laid end to end, as ``csr.runs_lookup_batch`` lays them,
    and the phase's queries."""
    import torch
    from repro_torch.kernels import lookup
    dev = u.device
    vcap = np.array([a.vcap for a in arrays], np.int64)
    keys = torch.cat([a.vkeys for a in arrays])
    offs = torch.from_numpy(np.cumsum(vcap) - vcap).to(dev)
    nv = torch.stack([a.nv for a in arrays]).int()
    args = (keys, offs, nv, u)
    got = lookup.batched_searchsorted_runs_cuda(*args)
    want = lookup.batched_searchsorted_runs_ref(*args)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"batched_searchsorted_runs differs from "
                             f"plain: {err}")
    del got, want
    r, b, n_keys = len(arrays), u.shape[0], int(nv.long().sum())
    # Every run's keys[:nv] and the queries read once, the [R, B] insertion
    # points written once; ~4 ops a bisection step, ~12 steps a pair.
    t_bound, by = bound(4 * n_keys + 4 * b + 12 * r + 4 * r * b,
                        4 * r * b * 12)
    # The library call: one torch.searchsorted over the plain version's
    # int64 (run, key) keys, made outside the timed call.
    slot = torch.arange(keys.shape[0], device=dev)
    run = torch.searchsorted(offs, slot, right=True) - 1
    k64 = torch.where(slot - offs[run] < nv.long()[run], keys.long(),
                      (1 << 31) - 1) + (1 << 31) | (run << 32)
    q64 = ((torch.arange(r, device=dev) << 32)[:, None]
           | (u.long() + (1 << 31))).reshape(-1)
    del slot, run

    def kern():
        return lookup.batched_searchsorted_runs_cuda(*args)

    return dict(
        name="batched_searchsorted_runs", route="cuda",
        source="src/repro_torch/csrc/lookup.cu",
        replaces="src/repro/kernels/lookup.py:48",
        max_abs_err=err, verdict="byte-equal to plain",
        ms=time_ms(kern, iters=20),
        device_ms=device_ms(kern, "searchsorted", iters=20),
        plain_ms=time_ms(
            lambda: lookup.batched_searchsorted_runs_ref(*args), iters=3,
            warmup=1),
        bound_ms=t_bound, bound_by=by,
        library_ms=time_ms(lambda: torch.searchsorted(k64, q64), iters=5,
                           warmup=1),
        shape=f"R={r} runs ({n_keys} keys in {keys.shape[0]} slots), "
              f"B={b}")


# ------------------------------------------------------------------ phase 6
def attention_inputs(dev, seed):
    """Random q, k, v from a seed: Qwen2-7B's heads at 4096 tokens in
    bfloat16, and bench_kernels.py's float32 shape."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 13)

    def rnd(b, h, s, d, dtype):
        return torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)

    qwen = tuple(rnd(1, h, QWEN_SEQ, QWEN_D, torch.bfloat16)
                 for h in (QWEN_HQ, QWEN_HKV, QWEN_HKV))
    b, hq, hkv, s, d = BENCH_ATTN
    bench = tuple(rnd(b, h, s, d, torch.float32) for h in (hq, hkv, hkv))
    return qwen, bench


def attention_path(qwen, bench, log=print):
    """The attention operator through its entry point: causal and
    non-causal at the Qwen2-7B shape in bfloat16, causal at the bench
    shape in float32."""
    import torch
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ops
    counts = flash.flash_attention_cuda.path_launches
    calls = (("causal", qwen, True, "tensor_cores"),
             ("noncausal", qwen, False, "tensor_cores"),
             ("f32", bench, True, "cuda_cores"))
    outs, took = {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name, inputs, causal, _ in calls:
        before = dict(counts)
        outs[name] = ops.attention(*inputs, causal=causal, use_pallas=True)
        took[name] = [p for p in counts if counts[p] != before[p]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name, o in outs.items():
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"attention {name}: non-finite output")
    for name, inputs, _, want in calls:
        if took[name] != [want]:
            raise AssertionError(f"attention {name} ({inputs[0].dtype}, D "
                                 f"{inputs[0].shape[-1]}) took {took[name]}"
                                 f", not {want}")
    log(f"attention: 3 calls through ops.attention(use_pallas=True) in "
        f"{wall * 1e3:.1f} ms (host clock, ending in a synchronise); "
        f"kernels {({k: v[0] for k, v in took.items()})}")
    return outs


def bf16_check(got, want):
    """(max |got - want|, largest ratio of |got - want| to its limit
    2^-7 |want| + 1e-4, whether both atol 2e-2 and that limit hold)."""
    diff = (got - want).abs()
    err = float(diff.max())
    ratio = float((diff / (ATT_BF16_REL * want.abs()
                           + ATT_BF16_FLOOR)).max())
    return err, ratio, err <= ATT_BF16_ATOL and ratio <= 1.0


def check_attention(qwen, bench, outs, log=print):
    """flash_attention against its plain version on the same inputs upcast
    to float32 (bfloat16: atol 2e-2 and, elementwise, 2^-7 |want| + 1e-4;
    float32: rtol 1e-3 / atol 2e-3), with a planted fault that the
    bfloat16 check must reject; times of kernel, plain version and SDPA at
    the Qwen2-7B causal shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash
    errs, ratios = {}, {}
    for name, inputs, causal in (("causal", qwen, True),
                                 ("noncausal", qwen, False),
                                 ("f32", bench, True)):
        want = flash.mha_ref(*(t.float() for t in inputs), causal=causal)
        got = outs[name].float()
        if name == "f32":
            err = float((got - want).abs().max())
            ok = torch.allclose(got, want, **ATT_F32_TOL)
        else:
            err, ratios[name], ok = bf16_check(got, want)
        errs[name] = err
        if name == "noncausal":
            # The planted fault: the non-causal output with one key of
            # 4,096 left out, rounded to bfloat16 as the kernel's output
            # is.  atol 2e-2 alone passes it; the check must reject it.
            q, k, v = (t.float() for t in inputs)
            keep = torch.ones(k.shape[2], dtype=torch.bool, device=k.device)
            keep[2048] = False
            bad = flash.mha_ref(q, k[:, :, keep], v[:, :, keep],
                                causal=False).to(torch.bfloat16).float()
            p_err, p_ratio, p_ok = bf16_check(bad, want)
            del q, k, v, bad
            if p_ok:
                raise AssertionError(
                    f"the bf16 check passed a planted fault: max abs err "
                    f"{p_err:.3e}, {p_ratio:.2f} of the scaled limit")
            log(f"attention check rejects a planted fault (key 2048 left "
                f"out, non-causal): max abs err {p_err:.3e} (within "
                f"atol {ATT_BF16_ATOL} alone: {p_err <= ATT_BF16_ATOL}), "
                f"{p_ratio:.2f} of the scaled limit")
        del want
        if not ok:
            raise AssertionError(f"flash_attention {name} differs from "
                                 f"plain: max abs err {err:.3e}, "
                                 f"{ratios.get(name, 0.0):.2f} of the "
                                 f"bf16 scaled limit")
    log(f"attention check: max abs err against the float32 plain version "
        f"{errs}, largest share of the bf16 scaled limit {ratios} (bounds: "
        f"bf16 atol {ATT_BF16_ATOL} and 2^-7 |want| + {ATT_BF16_FLOOR}, "
        f"f32 {ATT_F32_TOL})")
    q, k, v = qwen
    b, hq, s, d = q.shape
    flops = 4 * b * hq * s * s * d / 2          # causal: half the pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_bound, by = bound(nbytes, flops, BF16_TC_FLOPS)
    ms = time_ms(lambda: flash.flash_attention_cuda(q, k, v, causal=True),
                 iters=5, warmup=1)
    nc_ms = time_ms(lambda: flash.flash_attention_cuda(q, k, v,
                                                       causal=False),
                    iters=3, warmup=1)
    f32_ms = time_ms(lambda: flash.flash_attention_cuda(*bench, causal=True),
                     iters=10)
    library = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters=10)
    plain = time_ms(lambda: flash.mha_ref(q, k, v, causal=True), iters=3,
                    warmup=1)
    log(f"attention times: non-causal {nc_ms:.3f} ms at the Qwen2-7B shape "
        f"(tensor cores), causal float32 {f32_ms:.3f} ms at {BENCH_ATTN} "
        f"(CUDA cores)")
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:64",
        max_abs_err=errs["causal"],
        verdict=f"within atol {ATT_BF16_ATOL} and 2^-7 |want| + "
                f"{ATT_BF16_FLOOR} of the float32 plain version",
        ms=ms, plain_ms=plain, bound_ms=t_bound, bound_by=by,
        library_ms=library,
        shape=(f"B={b} Hq={hq} Hkv={k.shape[1]} S={s} D={d} bf16 causal, "
               f"tensor cores"),
        extra=dict(noncausal_ms=nc_ms, f32_ms=f32_ms, errs=errs,
                   limit_shares=ratios))


# ------------------------------------------------------------------ phase 7
# Bytes a durable run of the stream may hold on disk at once: each record
# is 17 bytes in the WAL and in a segment (dst, ts, prop, marker), the live
# segments and a compaction's new outputs (written before the files they
# replace go) are about twice the records, and the retained WAL
# generations stay below one more copy.
DURABLE_BYTES_PER_RECORD = 3 * 17


def _prefix_reads(stream, queries):
    """A last-writer-wins oracle of every stream prefix for ``queries``:
    ``at(tau)`` is the adjacency of each query from the first ``tau``
    records (the records whose ts is below a snapshot's τ)."""
    src, dst, ins = stream["src"], stream["dst"], stream["ins"]
    pick = np.flatnonzero(np.isin(src, queries))
    if pick.size == 0:
        return lambda tau: [np.empty(0, np.int64) for _ in queries]
    key = (src[pick] << 32) | dst[pick]
    order = np.lexsort((pick, key))
    pick, key = pick[order], key[order]
    start = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    q_of = src[pick[start]]

    def at(tau: int):
        seen = np.add.reduceat((pick < tau).astype(np.int64), start)
        last = pick[start + np.maximum(seen, 1) - 1]
        live = (seen > 0) & ins[last]
        s, d = q_of[live], dst[last[live]]
        pos = np.searchsorted(s, queries)
        end = np.searchsorted(s, queries, side="right")
        return [d[a:b] for a, b in zip(pos, end)]
    return at


def durable_path(dev, cfg, stream, queries, oracle, seed, log=print):
    """Phase 3's stream through a durable store on the card, wrapped by
    ``ConcurrentLSMGraph`` (group-commit WAL, a writer thread, a background
    compactor) while a reader thread pins snapshots; then close with a WAL
    tail, recover, read, evict every run, read cold, scrub.  Every read is
    held against the last-writer-wins oracle at its snapshot's τ.  The
    store lives in a fresh temporary directory, removed at the end."""
    import shutil
    import tempfile

    n_rec = int(stream["src"].shape[0])
    root = tempfile.mkdtemp(prefix="lsmg-durable-")
    try:
        free = shutil.disk_usage(root).free
        need = n_rec * DURABLE_BYTES_PER_RECORD
        log(f"disk: {free / 2**30:.2f} GiB free under {root}, the phase "
            f"needs up to {need / 2**30:.2f} GiB")
        if free < need:
            raise AssertionError(
                f"not enough disk for the durable phase: {free} bytes free, "
                f"{need} needed ({n_rec} records x "
                f"{DURABLE_BYTES_PER_RECORD} bytes)")
        return _durable_run(dev, cfg, stream, queries, oracle, seed, root,
                            log)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _durable_run(dev, cfg, stream, queries, oracle, seed, root, log):
    import threading

    import torch
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def allocated():
        return torch.cuda.memory_allocated(dev) if cuda else 0

    mem = {"start": allocated()}
    from repro_torch import obs
    from repro_torch.core.concurrent import ConcurrentLSMGraph
    from repro_torch.kernels import ops
    from repro_torch.storage import open_store

    src, dst, ins, prop = (stream[k] for k in ("src", "dst", "ins", "prop"))
    rng = np.random.default_rng(seed + 11)
    q_conc = np.sort(rng.choice(queries, min(4096, len(queries)),
                                replace=False))
    prefix = _prefix_reads(stream, q_conc)
    store = open_store(root, cfg, device=dev, wal_sync="batch")
    label = store.obs_label
    g = ConcurrentLSMGraph(store=store)
    pins, failures = [], []
    ingest_done = threading.Event()

    n_rec = int(src.shape[0])

    def read():
        with g.snapshot() as snap:
            tau = snap.tau
            t0 = time.perf_counter()
            out = snap.neighbors_batch(q_conc)
            pins.append((tau, out, time.perf_counter() - t0,
                         ingest_done.is_set()))

    def reader():
        # Pins a snapshot, reads, releases: once each time the ingest
        # passes another eighth of the stream, then until three in all.
        try:
            for mark in (n_rec * k // 8 for k in range(1, 8)):
                while store.tau < mark and not ingest_done.is_set():
                    ingest_done.wait(0.01)
                if ingest_done.is_set():
                    break
                read()
            while len(pins) < 3:
                read()
        except BaseException as e:  # surfaced by the main thread
            failures.append(e)

    t_reader = threading.Thread(target=reader, name="durable-reader")
    t0 = time.perf_counter()
    t_reader.start()
    try:
        off = 0
        for n in stream["sizes"]:
            sl = slice(off, off + n)
            if ins[off]:
                g.insert_edges(src[sl], dst[sl], prop=prop[sl])
            else:
                g.delete_edges(src[sl], dst[sl])
            off += n
        g.flush()                  # every queued batch applied
        sync()
        t_ingest = time.perf_counter() - t0
    finally:
        ingest_done.set()
        t_reader.join(timeout=600)
        if sys.exc_info()[0] is not None:
            g.close()              # stop the writer and the compactor
    if t_reader.is_alive():
        raise AssertionError("the reader thread did not finish")
    if failures:
        g.close()
        raise failures[0]
    during = sum(1 for p in pins if not p[3])
    if during < 3:
        raise AssertionError(f"only {during} snapshots were read during "
                             f"the ingest (want at least 3)")
    for tau, out, _dt, _late in pins:
        want = prefix(tau)
        bad = [int(q) for q, a, b in zip(q_conc, out, want)
               if not np.array_equal(a, b)]
        if bad:
            raise AssertionError(
                f"snapshot at tau {tau}: {len(bad)} of {len(q_conc)} "
                f"adjacency lists differ from the oracle, first {bad[:5]}")
    taus = [p[0] for p in pins]
    read_ms = [p[2] * 1e3 for p in pins]
    log(f"concurrent reads: {len(pins)} snapshots ({during} during the "
        f"ingest) at tau {taus[0]} .. {taus[-1]}, {len(q_conc)} queries "
        f"each, equal to the oracle at each tau; read wall median "
        f"{float(np.median(read_ms)):.1f} ms, max {max(read_ms):.1f} ms")
    comp = obs.REGISTRY.find("store_compaction_seconds", store=label)
    compactions = {h.labels["level"]: h.count for h in comp}
    flush = obs.REGISTRY.histogram("store_flush_seconds", store=label)
    flushes = flush.count
    # Where the ingest's time went, by the store's and the engine's spans
    # (host clock; the writer's MemGraph inserts and the compactor's flushes
    # and compactions overlap, the segment writes and fsyncs lie inside
    # the flushes and compactions).
    spans = {
        "memgraph_inserts": obs.REGISTRY.histogram(
            "store_apply_seconds", store=label).sum,
        "flushes": flush.sum,
        "compactions": {h.labels["level"]: round(h.sum, 2) for h in comp},
        "segment_writes": obs.REGISTRY.histogram(
            "storage_segment_write_seconds").sum,
        "wal_appends": obs.REGISTRY.histogram(
            "storage_wal_append_seconds").sum,
        "wal_fsyncs": obs.REGISTRY.histogram(
            "storage_wal_fsync_seconds").sum}
    io = store.io
    wal_b, seg_b, man_b = io.wal_write, io.segment_write, io.manifest_write
    log(f"durable ingest: {n_rec} records in {t_ingest:.1f} s = "
        f"{n_rec / t_ingest:.0f} records/s (wal_sync=batch); flushes "
        f"{flushes}, compactions by target level {compactions}; written: "
        f"WAL {wal_b} B, segments {seg_b} B, manifest {man_b} B")
    log("durable ingest time (spans, host clock, s): " + ", ".join(
        f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in spans.items()))
    tail = store.n_edges_cached()
    if tail == 0:
        raise AssertionError("no MemGraph tail at close: nothing to replay")
    mem["ingested"] = allocated()
    g.close()                      # no final flush: the WAL holds the tail
    del g, store
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    mem["closed"] = allocated()

    t0 = time.perf_counter()
    store = open_store(root, device=dev)
    sync()
    t_recover = time.perf_counter() - t0
    mem["recovered"] = allocated()
    label = store.obs_label
    replayed = sum(c.value for name in ("store_edges_inserted_total",
                                        "store_edges_deleted_total")
                   for c in obs.REGISTRY.find(name, store=label))
    runs = [len(lvl) for lvl in store.levels]
    sizes = store.level_sizes()
    l1_under_l2 = sum(1 for a in store.levels[1] for b in store.levels[2]
                      if a.min_vid <= b.max_vid and b.min_vid <= a.max_vid)
    log(f"recovery: {t_recover:.1f} s; {len(store.runs_by_fid)} segments "
        f"loaded, {replayed} WAL records replayed (tail {tail}); levels: "
        f"edges {sizes}, runs {runs}; {l1_under_l2} (L1, L2) run pairs "
        f"overlap")
    if not (runs[1] and runs[2]):
        raise AssertionError(f"L1 and L2 not both live after reopen: {runs}")
    if l1_under_l2 == 0:
        raise AssertionError("no L1 run overlaps an L2 run: the recovery "
                             "case of the reference's fault is not reached")

    rounds = _spine_rounds(store._state)[1]
    counts0 = ops.launch_counts()
    t0 = time.perf_counter()
    with store.snapshot() as snap:
        out = snap.neighbors_batch(queries)
    del snap
    t_read = time.perf_counter() - t0
    counts = {k: v - counts0[k] for k, v in ops.launch_counts().items()}
    n_out = check_oracle(queries, out, oracle, "the read after reopen")
    log(f"read after reopen: {len(queries)} queries ({n_out} edges) equal "
        f"to the oracle in {t_read * 1e3:.1f} ms; launches {counts}")
    if cuda:   # a CPU rehearsal runs the plain versions: no launches
        need_launches(counts, ("presence_matrix", "merge_pairs"),
                      "the read after reopen")
    if cuda and (counts["merge_pairs"], counts["merge_perm"]) != (rounds, 0):
        raise AssertionError(
            f"the read after reopen launched merge_pairs "
            f"{counts['merge_pairs']} times (want {rounds}, one a round) "
            f"and merge_perm {counts['merge_perm']} times (want 0)")

    resident = mem["read"] = allocated()
    n_evicted = store.durability.evict_all_segments()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    after_evict = mem["evicted"] = allocated()
    cold0, seg0 = store.io.cold_load, store.io.segment_read
    sched = obs.REGISTRY.counter("read_prefetch_scheduled_total")
    sched0 = sched.value
    t0 = time.perf_counter()
    with store.snapshot() as snap:
        out = snap.neighbors_batch(queries)
    del snap
    sync()
    t_cold = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    mem["cold_read"] = allocated()
    log("device memory allocated (GiB): " + ", ".join(
        f"{k} {v / 2**30:.3f}" for k, v in mem.items())
        + f"; peak of the cold read {peak / 2**30:.3f}")
    check_oracle(queries, out, oracle, "the cold read")
    cold_b, seg_rb = store.io.cold_load - cold0, store.io.segment_read - seg0
    log(f"cold read: {n_evicted} runs evicted (device memory "
        f"{resident / 2**30:.2f} -> {after_evict / 2**30:.2f} GiB); "
        f"{len(queries)} queries equal to the oracle in {t_cold * 1e3:.1f} "
        f"ms; {sched.value - sched0} prefetches scheduled; io.cold_load "
        f"{cold_b} B, segment bytes read {seg_rb} B; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    scrub = store.durability.scrub_once()
    t_scrub = time.perf_counter() - t0
    log(f"scrub: {scrub} in {t_scrub:.1f} s")
    if scrub["verified"] != len(store.runs_by_fid) or any(
            scrub[k] for k in ("healed_resident", "rebuilt", "degraded",
                               "transient")):
        raise AssertionError(f"scrub_once found trouble: {scrub}")
    disk = store.disk_bytes()
    store.close()
    return dict(records=n_rec, ingest_s=t_ingest,
                records_per_s=n_rec / t_ingest, spans_s=spans,
                flushes=flushes,
                compactions=compactions, wal_bytes=wal_b,
                segment_bytes=seg_b, manifest_bytes=man_b,
                snapshots=len(pins), snapshots_during_ingest=during,
                read_ms_median=float(np.median(read_ms)),
                recovery_s=t_recover, segments_loaded=sum(runs),
                wal_records_replayed=int(replayed), wal_tail=tail,
                level_sizes=sizes, runs=runs, l1_l2_overlaps=l1_under_l2,
                reopen_read_ms=t_read * 1e3, reopen_launches=counts,
                evicted=n_evicted, resident_gib=resident / 2**30,
                after_evict_gib=after_evict / 2**30,
                cold_read_ms=t_cold * 1e3, cold_load_bytes=cold_b,
                segment_read_bytes=seg_rb, cold_peak_gib=peak / 2**30,
                scrub=scrub, scrub_s=t_scrub, disk_bytes=disk,
                allocated_gib={k: v / 2**30 for k, v in mem.items()})


SHARDS = 4
# The phase's batches acked: every ACK_EVERY-th and the last.
ACK_EVERY = 64


def sharded_path(dev, cfg, stream, queries, oracle, seed, smi="",
                 log=print):
    """Phase 3's stream through a durable sharded store on the card (one
    directory a shard, a compaction scheduler running), read against the
    oracle, membership, health, then a reopen and the read again.  The
    store lives in a fresh temporary directory, removed at the end."""
    import shutil
    import tempfile

    n_rec = int(stream["src"].shape[0])
    root = tempfile.mkdtemp(prefix="lsmg-sharded-")
    try:
        free = shutil.disk_usage(root).free
        need = n_rec * DURABLE_BYTES_PER_RECORD
        log(f"disk: {free / 2**30:.2f} GiB free under {root}, the phase "
            f"needs up to {need / 2**30:.2f} GiB")
        if free < need:
            raise AssertionError(
                f"not enough disk for the sharded phase: {free} bytes "
                f"free, {need} needed")
        return _sharded_run(dev, cfg, stream, queries, oracle, seed, root,
                            smi, log)
    finally:
        t0 = time.perf_counter()
        shutil.rmtree(root, ignore_errors=True)
        log(f"sharded phase: directory removed in "
            f"{time.perf_counter() - t0:.2f} s")


def _shard_read(g, queries, oracle, what, smi, log):
    """One sharded read of ``queries`` with its launch counts: equal to the
    oracle with a clean degraded report, ``merge_pairs`` once a round of
    every shard's spine tournament, no ``merge_perm``."""
    import torch

    from repro_torch import obs
    from repro_torch.kernels import ops
    cuda = g.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(g.device)
        torch.cuda.reset_peak_memory_stats(g.device)
    spine0 = {sh.obs_label: obs.REGISTRY.histogram(
        "read_spine_build_seconds", store=sh.obs_label).sum
        for sh in g.shards}
    snap = g.snapshot()
    try:
        rounds = [_spine_rounds(s.state)[1] for s in snap.snaps]
        ops.reset_launches()
        t0 = time.perf_counter()
        out, rep = snap.neighbors_batch(queries, with_report=True)
        t_read = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        snap.release()
    peak = torch.cuda.max_memory_allocated(g.device) if cuda else 0
    spine_ms = [(obs.REGISTRY.histogram(
        "read_spine_build_seconds", store=sh.obs_label).sum
        - spine0[sh.obs_label]) * 1e3 for sh in g.shards]
    if not rep.ok:
        raise AssertionError(f"{what}: degraded report {rep}")
    t0 = time.perf_counter()
    n_out = check_oracle(queries, out, oracle, what)
    t_check = time.perf_counter() - t0
    log(f"{what}: {len(queries)} queries ({n_out} edges) over "
        f"{g.n_shards} shards equal to the oracle, report ok, in "
        f"{t_read * 1e3:.1f} ms; spine builds by shard (ms) "
        f"{[round(x, 1) for x in spine_ms]}; launches {counts}; spine "
        f"rounds by shard {rounds}; peak device memory "
        f"{peak / 2**30:.2f} GiB [{smi}]")
    if cuda:   # a CPU rehearsal runs the plain versions: no launches
        need_launches(counts, ("presence_matrix", "merge_pairs"), what)
        if (counts["merge_pairs"], counts["merge_perm"]) != (sum(rounds),
                                                             0):
            raise AssertionError(
                f"{what} launched merge_pairs {counts['merge_pairs']} times "
                f"(want {sum(rounds)}: one a round of each shard's spine, "
                f"{rounds}) and merge_perm {counts['merge_perm']} times "
                f"(want 0)")
    return dict(read_ms=t_read * 1e3, spine_ms=spine_ms, launches=counts,
                spine_rounds=rounds, peak_gib=peak / 2**30,
                oracle_check_s=t_check)


def _membership_pairs(oracle, vmax, seed, n=1 << 16):
    """``n`` (u, v) pairs, half of them live edges of the oracle, half drawn
    at random, with their membership in the oracle."""
    voff, odst, _prop = oracle
    rng = np.random.default_rng(seed + 13)
    e = rng.choice(odst.shape[0], n // 2, replace=False)
    u = np.concatenate([np.searchsorted(voff, e, side="right") - 1,
                        rng.integers(0, vmax, n - n // 2)]).astype(np.int64)
    v = np.concatenate([odst[e],
                        rng.integers(0, vmax, n - n // 2)]).astype(np.int64)
    # The oracle is sorted by (src, dst): its keys are sorted already.
    keys = (np.repeat(np.arange(vmax, dtype=np.int64), np.diff(voff)) << 32
            ) | odst
    q = (u << 32) | v
    pos = np.minimum(np.searchsorted(keys, q), keys.shape[0] - 1)
    return u, v, keys[pos] == q


def _sharded_run(dev, cfg, stream, queries, oracle, seed, root, smi, log):
    import torch

    from repro_torch import obs
    from repro_torch.shard import CompactionScheduler, open_sharded_store
    cuda = dev.type == "cuda"
    src, dst, ins, prop = (stream[k] for k in ("src", "dst", "ins", "prop"))
    n_rec = int(src.shape[0])
    log(f"sharded: {SHARDS} shards, each provisioned like the whole store "
        f"(scale_mem=False, as open_sharded_store and the service give "
        f"it): aggregate MemGraph budget {SHARDS} x {cfg.mem_edges} = "
        f"{SHARDS * cfg.mem_edges} edges, {SHARDS}x phase 3's")
    g = open_sharded_store(root, cfg, device=dev, n_shards=SHARDS,
                           wal_sync="batch")
    sched = CompactionScheduler(g)
    # The decision counters are process-wide: count this phase's ticks.
    decided = {d: c.value for d, c in sched._obs_decision.items()}
    sched.start()
    acks = []
    walls = {}   # the phase's other steps, host clock (s)
    try:
        t0 = time.perf_counter()
        off = 0
        n_batches = len(stream["sizes"])
        for i, n in enumerate(stream["sizes"]):
            sl = slice(off, off + n)
            if ins[off]:
                receipt = g.insert_edges(src[sl], dst[sl], prop[sl])
            else:
                receipt = g.delete_edges(src[sl], dst[sl])
            off += n
            if (i + 1) % ACK_EVERY == 0 or i + 1 == n_batches:
                ta = time.perf_counter()
                g.ack(receipt)
                acks.append(time.perf_counter() - ta)
        if cuda:
            torch.cuda.synchronize(dev)
        t_ingest = time.perf_counter() - t0
    finally:
        ts = time.perf_counter()
        sched.stop()
        walls["scheduler_stop"] = time.perf_counter() - ts
    ticks = {d: c.value - decided[d]
             for d, c in sched._obs_decision.items()}
    ack_ms = np.array(acks) * 1e3
    sizes = g.level_sizes()
    runs = [[len(lvl) for lvl in sh.levels] for sh in g.shards]
    tails = [sh.n_edges_cached() for sh in g.shards]
    log(f"sharded ingest: {n_rec} records in {t_ingest:.1f} s = "
        f"{n_rec / t_ingest:.0f} records/s routed into {SHARDS} shards "
        f"(wal_sync=batch) [{smi}]")
    log(f"sharded acks: {len(acks)} (every {ACK_EVERY}th batch and the "
        f"last), wall (ms) sum {ack_ms.sum():.1f}, p50 "
        f"{float(np.median(ack_ms)):.2f}, max {ack_ms.max():.2f} [{smi}]")
    log(f"compaction scheduler decisions {ticks}; levels by shard: edges "
        f"{sizes}, runs {runs}, active MemGraph {tails} [{smi}]")
    # No final flush: every shard keeps its MemGraph tail; the scheduler
    # may drain a shard's L0, so L0 and L1+ are held live store-wide.
    live = [all(tails), any(r[0] for r in runs), any(sum(r[1:]) for r in runs)]
    if not all(live):
        raise AssertionError(f"MemGraph tails on every shard, L0 and L1+ "
                             f"not all live: {live}; tails {tails}, runs "
                             f"{runs}")

    read = _shard_read(g, queries, oracle, "sharded read", smi, log)
    ts = time.perf_counter()
    u, v, want = _membership_pairs(oracle, cfg.vmax, seed)
    walls["membership_oracle"] = time.perf_counter() - ts
    t0 = time.perf_counter()
    with g.snapshot() as snap:
        got = snap.query_edges_batch(u, v)
    t_member = time.perf_counter() - t0
    if not np.array_equal(got, want):
        raise AssertionError(
            f"query_edges_batch: {int((got != want).sum())} of {len(u)} "
            f"pairs differ from the oracle")
    log(f"membership: {len(u)} pairs ({int(want.sum())} edges) equal to "
        f"the oracle in {t_member * 1e3:.1f} ms [{smi}]")
    ts = time.perf_counter()
    health = g.health_report()
    walls["health_report"] = time.perf_counter() - ts
    bad = {s: e for s, e in health.items()
           if e["status"] != "ok" or e["amplification"]["write"] is None}
    if bad:
        raise AssertionError(f"health_report: {bad}")
    amp = {s: e["amplification"] for s, e in health.items()}
    log(f"health: every shard ok; amplification by shard {amp} [{smi}]")
    disk = g.disk_bytes()
    ts = time.perf_counter()
    g.close()
    del g
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    walls["close"] = time.perf_counter() - ts

    t0 = time.perf_counter()
    g = open_sharded_store(root, device=dev)
    if cuda:
        torch.cuda.synchronize(dev)
    t_recover = time.perf_counter() - t0
    replayed = [sum(c.value for name in ("store_edges_inserted_total",
                                         "store_edges_deleted_total")
                    for c in obs.REGISTRY.find(name, store=sh.obs_label))
                for sh in g.shards]
    log(f"recovery: {SHARDS} shards in parallel in {t_recover:.1f} s; "
        f"WAL records replayed by shard {replayed} (tails at close "
        f"{tails}); levels by shard {g.level_sizes()} [{smi}]")
    if not any(replayed):
        raise AssertionError("no shard replayed a WAL tail")
    again = _shard_read(g, queries, oracle, "sharded read after reopen",
                        smi, log)
    ts = time.perf_counter()
    g.close()
    walls["close_after_reopen"] = time.perf_counter() - ts
    log("sharded phase, other steps (host clock, s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in walls.items()) + f" [{smi}]")
    return dict(walls_s=walls,records=n_rec, ingest_s=t_ingest,
                records_per_s=n_rec / t_ingest, acks=len(acks),
                ack_ms_p50=float(np.median(ack_ms)),
                ack_ms_max=float(ack_ms.max()),
                ack_ms_sum=float(ack_ms.sum()), scheduler=ticks,
                level_sizes=sizes, runs=runs, mem_tails=tails,
                read=read, membership_ms=t_member * 1e3,
                disk_bytes=disk, recovery_s=t_recover,
                wal_records_replayed=replayed, reopen_read=again)


def _service(argv, log):
    """``graph_service.main(argv)`` in this process, with its launches and
    its printed lines (echoed)."""
    import io

    from repro_torch.kernels import ops
    from repro_torch.launch import graph_service
    buf = io.StringIO()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        graph_service.main(argv)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for line in buf.getvalue().splitlines():
        log(f"  service: {line}")
    return buf.getvalue(), counts, wall


def _report_families(path, extra=()):
    """The checks of ``tools/obs_smoke.py`` on a service metrics report."""
    doc = json.loads(Path(path).read_text())
    if doc.get("schema") != "lsmg-metrics-report-v1":
        raise AssertionError(f"{path}: schema {doc.get('schema')!r}")
    need = {"store", "read", "storage", "io", "merge", *extra}
    fams = set()
    for snap in doc["phases"].values():
        fams |= set(snap["families"])
    if not need <= fams:
        raise AssertionError(f"{path}: families {sorted(fams)} lack "
                             f"{sorted(need - fams)}")
    return sorted(doc["phases"]), sorted(fams)


def service_path(dev, smi="", log=print):
    """Phase 9: the graph service on the card at its own default size,
    once on one durable store and once sharded with the chaos phase."""
    import shutil
    import tempfile

    from repro_torch import obs
    root = Path(tempfile.mkdtemp(prefix="lsmg-service-"))
    try:
        base = ["--device", str(dev)]
        text1, c1, w1 = _service(
            base + ["--durable", str(root / "d1"), "--analytics",
                    "pagerank-multilevel", "--metrics", str(root / "m1.json"),
                    "--trace", str(root / "t1.json")], log)
        obs.REGISTRY.disable_tracing()
        text2, c2, w2 = _service(
            base + ["--shards", str(SHARDS), "--durable", str(root / "d2"),
                    "--chaos", "--analytics", "2hop", "--metrics",
                    str(root / "m2.json")], log)
        if "edge set restored" not in text2:
            raise AssertionError("the chaos phase did not restore the edge "
                                 "set")
        if "after restart: OK" not in text1 or \
                "after restart: OK" not in text2:
            raise AssertionError("a service run failed its restart check")
        r1 = _report_families(root / "m1.json")
        r2 = _report_families(root / "m2.json", ("shard", "compaction"))
        trace = json.loads((root / "t1.json").read_text())
        spans = sum(1 for e in trace["traceEvents"] if e["ph"] == "X")
        if spans < 1:
            raise AssertionError("the service trace holds no span")
        if dev.type == "cuda":
            need_launches(c1, ("presence_matrix", "merge_pairs",
                               "gather_segsum_runs"), "service run 1")
            need_launches(c2, ("presence_matrix", "merge_pairs"),
                          "service run 2")
        log(f"service run 1 (durable, pagerank-multilevel): {w1:.1f} s, "
            f"launches {c1}, report phases {r1[0]}, families {r1[1]}, "
            f"trace {spans} spans [{smi}]")
        log(f"service run 2 (4 shards, durable, chaos, 2hop): {w2:.1f} s, "
            f"launches {c2}, report phases {r2[0]}, families {r2[1]} "
            f"[{smi}]")
        return dict(run1=dict(wall_s=w1, launches=c1),
                    run2=dict(wall_s=w2, launches=c2), trace_spans=spans)
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    # The plain versions' float32 products in full float32, as the
    # reference's tolerances assume (PyTorch's default, stated here).
    torch.backends.cuda.matmul.allow_tf32 = False
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
        dev_ms = (f" ({r['device_ms']:.4f} ms device)"
                  if "device_ms" in r else "")
        print(f"kernel {r['name']} ({r['shape']}): byte-equal to plain; "
              f"{r['ms']:.4f} ms{dev_ms}, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{smi}]")
    print(f"kernel presence_matrix: every row at FILTER_MIN_BITS "
          f"{rows[0]['probe_min_bits_ms']:.4f} ms device [{smi}]")

    if args.edges != EDGEFACTOR << SCALE:
        print(f"reduced: edges {args.edges} of {EDGEFACTOR << SCALE}")
    ops.reset_launches()
    stats = main_path(dev, store_config(), args.edges, 1 << 16, args.seed)
    launches = {"store": ops.launch_counts()}
    print(f"main path (store) launches: {launches['store']}")
    need_launches(launches["store"], ("presence_matrix", "merge_pairs"),
                  "the store's path")
    got_rounds = (launches["store"]["merge_pairs"],
                  launches["store"]["merge_perm"])
    if got_rounds != (stats["spine_rounds"], 0):
        raise AssertionError(
            f"the spine build launched merge_pairs {got_rounds[0]} times "
            f"(want one a round: {stats['spine_rounds']}) and merge_perm "
            f"{got_rounds[1]} times (want 0)")
    store, queries = stats.pop("store"), stats.pop("query_vertices")
    oracle, stream = stats.pop("oracle"), stats.pop("stream")
    print(f"main path (store): {json.dumps(stats)}")
    profile_read(store, queries, dev)
    with _uncounted():
        rows.append(check_merge_pairs(store))
    r = rows[-1]
    print(f"kernel {r['name']} ({r['shape']}): byte-equal to plain; "
          f"{r['ms']:.3f} ms ({r['device_ms']:.3f} ms device), plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}), library none [{smi}]")

    ops.reset_launches()
    t0 = time.perf_counter()
    an = analytics_path(dev, store, oracle, args.seed,
                        check=lambda view: check_segment_kernels(
                            view, args.seed),
                        check_runs=lambda views: check_segsum_runs(
                            views, store.cfg.vmax, args.seed))
    launches["analytics"] = ops.launch_counts()
    print(f"main path (analytics) launches: {launches['analytics']}")
    need_launches(launches["analytics"], ("gather_segsum", "gather_segmin",
                                          "gather_segsum_runs"),
                  "the analytics path")
    if args.edges == EDGEFACTOR << SCALE and args.seed == 0:
        got = dict(launches={k: launches["analytics"][k]
                             for k in SEED0_ANALYTICS["launches"]},
                   iterations={k: an["steps"][k]["iterations"]
                               for k in SEED0_ANALYTICS["iterations"]})
        if got != SEED0_ANALYTICS:
            raise AssertionError(f"analytics launches and iterations {got}, "
                                 f"not {SEED0_ANALYTICS}")
    for r in an["rows"]:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.3f} ms")
        dev_ms = (f" ({r['device_ms']:.3f} ms device)"
                  if "device_ms" in r else "")
        print(f"kernel {r['name']} ({r['shape']}): {r['verdict']} (max abs "
              f"err {r['max_abs_err']}); {r['ms']:.3f} ms{dev_ms}, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {lib} [{smi}]")
        if "reduce_ms" in r:
            print(f"kernel {r['name']}: device ms of the reduction kernel "
                  f"alone {r['reduce_ms']:.4f}; on the probes dst = 0 "
                  f"{r['probe_zero_ms']:.4f}, dst = seg_id "
                  f"{r['probe_seq_ms']:.4f}; all kernels of a call "
                  f"(launches, ms) {r['device_kernels']} [{smi}]")
    rows += an.pop("rows")
    print(f"main path (analytics): {json.dumps(an)}; phase "
          f"{time.perf_counter() - t0:.1f} s")

    ops.reset_launches()
    t0 = time.perf_counter()
    f16, largest, arrays, u = fig16_path(dev, store, queries, oracle)
    launches["fig16"] = ops.launch_counts()
    print(f"main path (fig16) launches: {launches['fig16']}")
    need_launches(launches["fig16"], ("batched_searchsorted",
                                      "batched_searchsorted_runs"),
                  "the Fig 16 path")
    if launches["fig16"]["batched_searchsorted"] != f16["probe"]["runs"]:
        raise AssertionError("batched_searchsorted did not launch once a run")
    if launches["fig16"]["batched_searchsorted_runs"] != 1:
        raise AssertionError("the one-launch probe launched "
                             "batched_searchsorted_runs "
                             f"{launches['fig16']['batched_searchsorted_runs']}"
                             " times, not once")
    rows.append(check_lookup(largest, u))
    rows.append(check_lookup_runs(arrays, u))
    print(f"main path (fig16): {json.dumps(f16)}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    del store, u, largest, arrays

    qwen, bench = attention_inputs(dev, args.seed)
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = attention_path(qwen, bench)
    launches["attention"] = ops.launch_counts()
    print(f"main path (attention) launches: {launches['attention']}")
    need_launches(launches["attention"], ("flash_attention",),
                  "the attention path")
    rows.append(check_attention(qwen, bench, outs))
    print(f"main path (attention): phase {time.perf_counter() - t0:.1f} s")
    rows_attention = rows[-3:]
    del qwen, bench, outs
    # The profiled read's frame, which torch.profiler keeps alive until a
    # collection, still holds phase 3's store (about 9 GiB on the card).
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory allocated before phase 7: "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB")

    ops.reset_launches()
    t0 = time.perf_counter()
    dur = durable_path(dev, store_config(), stream, queries, oracle,
                       args.seed)
    launches["durable"] = ops.launch_counts()
    print(f"main path (durable) launches: {launches['durable']}")
    need_launches(launches["durable"], ("presence_matrix", "merge_pairs"),
                  "the durable path")
    if launches["durable"]["merge_perm"]:
        raise AssertionError("the durable path launched merge_perm")
    print(f"main path (durable): ingest {dur['records_per_s']:.0f} "
          f"records/s durable and concurrent against "
          f"{stats['records'] / stats['ingest_s']:.0f} records/s in memory "
          f"(phase 3) [{smi}]")
    print(f"main path (durable): {json.dumps(dur)}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    shd = sharded_path(dev, store_config(), stream, queries, oracle,
                       args.seed, smi)
    launches["sharded"] = shd["read"]["launches"]
    print(f"main path (sharded) launches: {launches['sharded']}")
    print(f"main path (sharded): ingest {shd['records_per_s']:.0f} "
          f"records/s routed into {SHARDS} durable shards against "
          f"{dur['records_per_s']:.0f} records/s durable (phase 7) and "
          f"{stats['records'] / stats['ingest_s']:.0f} records/s in memory "
          f"(phase 3); read {shd['read']['read_ms']:.1f} ms against "
          f"{stats['spine_ms']:.1f} ms spine build in phase 3; recovery "
          f"{shd['recovery_s']:.1f} s; disk {shd['disk_bytes']} B [{smi}]")
    print(f"main path (sharded): {json.dumps(shd)}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    svc = service_path(dev, smi)
    launches["service"] = {"run1": svc["run1"]["launches"],
                           "run2": svc["run2"]["launches"]}
    print(f"main path (service) launches: {launches['service']}")
    print(f"main path (service): {json.dumps(svc)}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    for r in rows_attention:
        lib = f"{r['library_ms']:.4f} ms"
        dev_ms = (f" ({r['device_ms']:.4f} ms device)"
                  if "device_ms" in r else "")
        print(f"kernel {r['name']} ({r['shape']}): {r['verdict']} (max abs "
              f"err {r['max_abs_err']}); {r['ms']:.4f} ms{dev_ms}, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {lib} [{smi}]")
        if "note" in r:
            print(f"kernel {r['name']}: {r['note']} [{smi}]")
    print(f"total {time.perf_counter() - t_all:.1f} s")
    phase_of = {"presence_matrix": "store", "merge_perm": "store",
                "merge_pairs": "store",
                "gather_segsum": "analytics", "gather_segmin": "analytics",
                "gather_segsum_runs": "analytics",
                "batched_searchsorted": "fig16",
                "batched_searchsorted_runs": "fig16",
                "flash_attention": "attention"}
    kernels = [{k: r[k] for k in ("name", "route", "source", "replaces")}
               | {"launches": launches[phase_of[r["name"]]][r["name"]]}
               | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}
               | ({"device_ms": r["device_ms"]} if "device_ms" in r else {})
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
