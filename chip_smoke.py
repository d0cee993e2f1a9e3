#!/usr/bin/env python3
"""Smoke run of the PyTorch port of LSMGraph on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--edges N]

(``--train-replay DIR [--device D]`` runs only phase 13 (d)'s child.)

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
10. The paper's benchmark harness on the card, in this process:
    every suite of ``repro_torch.benchmarks.run.suites()`` (Figs 10 to 18,
    the kernels, batched reads, presence filters, durability and sharded
    scaling), each with its stores on the card beside the four baseline
    systems on the host, at the reference's paper-shaped scale
    (``BENCH_SCALE=large``: 2,000 vertices and 300,000 power-law edges
    asked, of which the generator keeps the distinct ones; the sharded
    suite 8,000 vertices, 960,000 edges).  Every row is printed with the
    card's name and power limit, and each suite's kernel launches.  A
    suite that raises fails the phase; every row must keep the harness's
    schema, ``sharded_oracle_concurrent`` must read ``identical=True``, the
    kernel rows must name ``route=cuda``, and across the suites
    ``presence_matrix``, ``merge_pairs``, ``gather_segsum``,
    ``gather_segmin`` and ``flash_attention`` must each launch.  Where
    ``batched_searchsorted`` does not launch, the phase says why.
11. The distributed graph layer on the card: the last-writer-wins CSR of
    phase 3's whole stream (4,194,304 vertices) partitioned over 4 shards
    by ``partition_csr``; 4 ranks (processes started with ``spawn``,
    joined by gloo through a temporary file, every shard on this card,
    collectives staged through the host) run distributed PageRank for 10
    iterations with each of the fp32, bf16 and int8 exchanges, each held
    against the single-store ``analytics.pagerank`` of the same CSR on the
    card and against float64 power iteration on the host (max |d| /
    max(pr) under 1e-5, 2e-2 and 5e-2, and relative L1 under 1e-4, 1e-3
    and 1e-2, for each witness); ``gather_segsum`` must
    launch once a rank an iteration an exchange (120 in all), and rank 0
    holds it against its plain version at its shard's shapes (not
    counted).  Then phase 3's batches (rank r every 4th) through
    ``make_mesh_write_router`` with buckets of the batch size: every
    shard's records, markers included, equal to the host router's
    (``bucket_edge_batches``) on the same batches, none dropped.  A rank
    that raises or times out fails the phase.
12. An LM served on the card: Qwen2-1.5B at full width (28 layers,
    d_model 1,536, 12/2 heads, head_dim 128, vocab 151,936, 1.54 B
    parameters) with random bfloat16 weights from a generator on the card
    seeded by ``--seed``, through ``repro_torch.launch.serve``'s functions,
    eager: request A (batch 4 x prompt 512, 32 greedy decode steps,
    ``full_attention``) and request B (batch 1 x prompt 16,384, 8 steps,
    ``chunked_attention``), each with its prefill and decode times,
    tokens/s, bounds and peak device memory.  Then, each failing the
    phase: (a) with a float32 copy of the weights, ``decode_step`` after
    ``prefill(t[:k])`` against ``prefill(t[:k+1])``'s last logits within
    rtol = atol = 2e-2 (the reference's own tolerance); (b) request A's
    bf16 prefill logits against the float32 copy's, relative L1 under
    5e-2; (c) one reduced config of each family (dense, MLA + MoE,
    dense-residual MoE, hybrid, SSM, encdec, vision prefix), prefill and
    4 decode steps on the card against the port on the CPU, float32
    weights and cache, within rtol = atol = 1e-3; (d) layer 0's post-RoPE q, k, v of request
    A through ``ops.attention(use_pallas=True)``: ``flash_attention`` on
    the tensor cores at a GQA ratio of 6, launched exactly once, held
    against the plain version on float32-upcast inputs (phase 6's bf16
    check) and against the model's own ``full_attention`` (relative L1
    under 2e-2), timed beside it.  No graph-store kernel may launch in
    the phase.
13. An LM trained on the card: Qwen2-1.5B at full width and depth with
    random bfloat16 weights from a generator on the card seeded by
    ``--seed`` and remat on (its config's), 4 steps of
    ``repro_torch.launch.train.make_train_step`` (8 x 4,096 tokens from
    ``TokenPipeline``, 4 micro-batches, cosine schedule, AdamW), eager:
    each step's ms and tokens/s beside the step's bound (its FLOPs on bf16
    tensor cores), peak device memory, and the device's busy share of one
    more, profiled step.  Then, each failing the phase: (a) step 0's loss
    finite and in [11, 13.5], every parameter bit-equal after it (lr 0),
    every later loss finite; (b) one micro-batch's loss and gradients with
    the bf16 weights against a float32 copy's: loss relative difference
    under 1e-2, relative L2 of all gradients under 1e-1; (c) one reduced
    config of each family, float32: the loss and every gradient on the
    card within rtol = atol = 1e-3 of the CPU's, and every parameter after
    one AdamW update of the CPU's gradients (lr 1e-3) too; (d) in a child
    process with deterministic algorithms, ``launch.train``'s ``main`` on
    reduced qwen2-1.5b (bf16) for 12 steps with a checkpoint every 4, once
    clean and once with failures at 5 and 9: 2 restarts, every restored
    bf16 leaf bf16, the losses from step 8 and the final checkpoint equal
    to the clean run's; (e) ``compress_int8`` of (b)'s bf16 embed
    gradient on the card byte-equal to the CPU's, values and scales, and
    ``decompress_int8`` within max|g|/127.  No kernel may launch in the
    phase.
14. The dry run against the card (``repro_torch.launch.dryrun`` on its
    ``card`` mesh: fake CUDA tensors, no mesh): (a) phase 13's step and
    (b) phase 12's request A (its prefill into a 552-deep cache, then one
    decode step) traced, then run for real from a reset peak, once with
    no dispatch mode and once under ``FlopCounterMode``'s counting mode:
    the traced peak must lie within ``dryrun.PEAK_TOL`` of the plain
    step's ``torch.cuda.max_memory_allocated`` above what was allocated
    before the step's inputs, and the traced FLOPs equal the counted
    step's (whose peak is printed beside); (c) (a)'s three
    roofline terms beside phase 13's measured step and its hand bound
    (``training_bound``); (d) qwen2-1.5b x train_4k and deepseek-v2-236b x
    prefill_32k on the single-pod mesh and the graph dry run, traced on
    the host's CPU in child processes started at the phase's start, each
    ``ok``, each wall time printed.  No kernel may launch in the phase.
15. A ``{"kernels": [...]}`` line (``gather_segsum``'s row adds phase 11's
    launches as ``launches_distributed``, ``flash_attention``'s phase 12's
    as ``launches_serving``), the ``nvidia-smi`` line, and the last line
    ``{"ok": true, "device": {...}}``.

The launch counters are zeroed just before phases 3 to 10, 12 to 14 (each
run of phase 9, each read of phase 8 and each suite of phase 10) and read
just after each; each rank of phase 11 zeroes its own before its PageRank runs
and reads them after.  The port imports neither ``jax`` nor the JAX package; this
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
# H100 SXM float32 rate outside the tensor cores (data sheet): the bound
# of float32 products computed without TF32.
FP32_FLOPS = 67e12
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
                # Kernels whose names share 60 characters add up.
                n0, ms0 = by_kernel.get(e.key[:60], (0.0, 0.0))
                by_kernel[e.key[:60]] = (n0 + e.count / iters,
                                         ms0 + t / e.count * per_call / 1e3)
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


def pagerank_f64(voff, dst, iters):
    """PageRank (damping 0.85) of the CSR (voff, dst) by float64 power
    iteration on the host: the independent reference of phases 4 and 11."""
    import scipy.sparse as sp
    n = len(voff) - 1
    deg = np.diff(voff)
    a = sp.csr_matrix((np.ones(len(dst)), dst, voff), shape=(n, n))
    x = np.full(n, 1.0 / n)
    for _ in range(iters):
        y = a @ (x / np.maximum(deg, 1))
        x = 0.15 / n + 0.85 * (y + x[deg == 0].sum() / n)
    return x


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

    x = pagerank_f64(voff_o, dst_o, 10)
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


# ------------------------------------------------------------------ phase 10
# Kernels the benchmark suites must launch between them.
BENCH_KERNELS = ("presence_matrix", "merge_pairs", "gather_segsum",
                 "gather_segmin", "flash_attention")


def _bench_agree(name, kind, got, want, worst):
    """Hold one of phase 10's outputs (a tensor, or SCAN's pair) against
    its plain counterpart, with the tolerance of its ``kind`` (see
    ``check_bench_outputs``); ``worst[kind]`` keeps the largest error seen
    (relative L1 for PageRank, else the largest absolute error) and its
    output's name."""
    import torch
    if kind == "scan":                 # (degree, weight sum)
        _bench_agree(name, "degree", got[0], want[0], worst)
        _bench_agree(name, "wsum", got[1], want[1], worst)
        return
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    if got.shape != want.shape or got.dtype != want.dtype:
        ok, how = False, "shape or dtype"
    elif kind in ("sssp", "bfs", "cc", "degree"):
        ok, how = torch.equal(_pos_zero(got), _pos_zero(want)), "equal"
    elif kind == "pagerank":
        err = float((got.double() - want.double()).abs().sum()
                    / want.double().abs().sum().clamp_min(1e-300))
        ok, how = err <= PR_REL_L1, f"relative L1 {err:.3e} <= {PR_REL_L1}"
    elif kind == "wsum":
        ok = torch.allclose(got, want, rtol=WSUM_RTOL, atol=0.0)
        how = f"rtol {WSUM_RTOL}"
    elif kind == "segsum":
        ok = torch.allclose(got, want, rtol=SEG_RTOL, atol=SEG_ATOL)
        how = f"rtol {SEG_RTOL} / atol {SEG_ATOL}"
    else:                              # "attention", float32
        ok = torch.allclose(got, want, **ATT_F32_TOL)
        how = f"rtol {ATT_F32_TOL['rtol']} / atol {ATT_F32_TOL['atol']}"
    if not ok:
        raise AssertionError(f"phase 10: {name} ({kind}) differs from its "
                             f"plain version ({how}; error {err:.3e})")
    if kind not in worst or err > worst[kind][0]:
        worst[kind] = (err, name)


def check_bench_outputs(dev, log=print):
    """Phase 10's outputs held against plain versions at the suites' own
    shapes and scale (launches here do not count):

    - ``bench_kernels``' inputs: ``gather_segsum`` within tests/
      test_kernels.py's rtol 1e-5 / atol 1e-4, float32 attention within its
      rtol 1e-3 / atol 2e-3;
    - Fig 12 (``bench_analytics``' ingest, every system's view): SSSP, BFS
      and CC through the kernels equal to the same algorithm through the
      plain versions (a min is exact in any order), SCAN's degrees equal
      (integer sums) and its weight sums within rtol 1e-4, PageRank within
      relative L1 1e-4 (phase 4's float32 budgets);
    - the LSMGraph's ``materialize_csr`` (presence_matrix and merge_pairs
      at the suite's shapes) equal, offsets, neighbours and properties, to
      the in-place CSR baseline's numpy CSR of the same stream."""
    import numpy as np
    from repro_torch.analytics import materialize_csr
    from repro_torch.benchmarks import bench_analytics, bench_kernels
    from repro_torch.benchmarks.common import scale
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import mha_ref
    from repro_torch.kernels.segment_reduce import gather_segsum_ref
    worst = {}
    t0 = time.perf_counter()
    with _uncounted():
        z = bench_kernels.inputs(dev)
        _bench_agree("kernel_segsum", "segsum",
                     ops.gather_segsum(z.dst, z.seg, z.wt, z.x, n_out=z.v),
                     gather_segsum_ref(z.dst, z.seg, z.wt, z.x, z.v), worst)
        _bench_agree("kernel_attn", "attention",
                     ops.attention(z.q, z.k, z.vv, use_pallas=True),
                     mha_ref(z.q, z.k, z.vv), worst)

        V = scale().V
        systems, source = bench_analytics.ingest(dev)
        kern = bench_analytics.algorithms(source)
        plain = bench_analytics.algorithms(source, use_pallas=False)
        for name, sys_ in systems.items():
            snap = None
            if name == "lsmgraph":
                snap = sys_.snapshot()
                view = materialize_csr(snap, V)
                voff, dst, prop = systems["csr_inplace"].snapshot_csr(
                    charge_read=False)
                n = int(voff[-1])
                same = (view.n_edges == n
                        and np.array_equal(view.voff.cpu().numpy(), voff)
                        and np.array_equal(view.dst[:n].cpu().numpy(),
                                           dst[:n])
                        and np.array_equal(view.prop[:n].cpu().numpy(),
                                           prop[:n]))
                if not same:
                    raise AssertionError(
                        "phase 10: the LSMGraph's materialize_csr differs "
                        "from the in-place CSR baseline's numpy CSR")
            else:
                view = bench_analytics._view_from_baseline(sys_, V, dev)
            for aname in kern:
                _bench_agree(f"fig12_{aname}_{name}", aname,
                             kern[aname](view), plain[aname](view), worst)
            if snap is not None:
                snap.release()
    secs = time.perf_counter() - t0
    log(f"phase 10 outputs ({secs:.1f} s): the LSMGraph's CSR "
        f"({view.n_vertices} vertices, {n} edges) equals the in-place "
        f"CSR's; Fig 12's {len(kern)} algorithms on {len(systems)} "
        f"systems agree with the plain versions; worst error by kind "
        f"(PageRank: relative L1, else max abs): " + ", ".join(
            f"{kind} {err:.3e} ({name})"
            for kind, (err, name) in sorted(worst.items())))
    return dict(seconds=secs, worst=worst)


def benchmarks_path(dev, smi="", large=True, log=print):
    """Phase 10: every suite of the port's benchmark harness on ``dev``, at
    ``BENCH_SCALE=large`` (``large``) or the default scale; each suite's
    rows checked and printed with ``smi``, and its launches counted from
    zero."""
    import io

    from repro_torch.benchmarks import common, smoke
    from repro_torch.benchmarks.run import suites
    from repro_torch.kernels import ops
    sc = common.Scale(scale=10 if large else 1)
    total = dict.fromkeys(ops.KERNELS, 0)
    per_suite, rows = {}, {}
    with common.use_scale(sc):
        for label, fn in suites():
            buf = io.StringIO()
            ops.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                fn(dev)
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
            errors = smoke._check_rows(lines) or (
                [] if lines else ["no rows"])
            if errors:
                raise AssertionError(f"suite {label}: {errors[:5]}")
            for line in lines:
                log(f"bench {line} [{smi}]")
                name, us, derived = line.split(",", 2)
                rows[name] = (float(us), derived)
            launched = {k: v for k, v in counts.items() if v}
            log(f"bench launches ({label}): {launched}; {wall:.1f} s "
                f"[{smi}]")
            per_suite[label] = dict(seconds=wall, launches=launched)
            for k, v in counts.items():
                total[k] += v
        check_bench_outputs(dev, log)
    if rows["sharded_oracle_concurrent"][1] != "identical=True":
        raise AssertionError(f"sharded_oracle_concurrent: "
                             f"{rows['sharded_oracle_concurrent'][1]}")
    if dev.type == "cuda":   # a CPU rehearsal runs the plain versions
        for name in ("kernel_segsum_kernel", "kernel_attn_kernel"):
            if "route=cuda" not in rows[name][1].split(";"):
                raise AssertionError(f"{name} did not run the kernel: "
                                     f"{rows[name][1]}")
        need_launches(total, BENCH_KERNELS, "the benchmark suites")
    by = [label for label, v in per_suite.items()
          if v["launches"].get("batched_searchsorted")]
    if by:
        log(f"batched_searchsorted launched in {by}")
    else:
        log("batched_searchsorted: no launch in the suites. Fig 16's "
            "index-off read is a point read (Snapshot.neighbors of one "
            "vertex takes neighbors_scalar, as in the reference), which "
            "finds a vertex's slice in each run by csr.run_lookup, a "
            "torch.searchsorted of one key (the reference's: a "
            "jnp.searchsorted); the kernel lies on run_lookup_batch("
            "use_pallas=True) and csr.runs_lookup_batch, which phase 5 "
            "drives")
    return dict(scale=dict(V=sc.V, E=sc.E, scale=sc.scale),
                suites=per_suite, launches=total, rows=len(rows))


# ------------------------------------------------------------------ phase 11
DIST_RANKS = 4
DIST_ITERS = 10
# Distributed PageRank is held against two witnesses of the same CSR: the
# port's single-store PageRank on the card, and float64 power iteration on
# the host (``pagerank_f64``, independent of every kernel; the plain
# float32 reduce is no witness at 1e-5 of the largest rank, since
# index_add_ adds a hub's in-edges one at a time).
DIST_WITNESSES = ("card", "f64")
# max |d| / max(pr).  fp32: at scale 22 a rank is about 2.4e-7, so an
# absolute 1e-6 could not fail; float32 sums in another order stay far
# below 1e-5 of the largest.  bf16 and int8: tests/test_distributed.py's
# bounds, measured as there.
DIST_BOUND = {"fp32": 1e-5, "bf16": 2e-2, "int8": 5e-2}
# And the relative L1 over all vertices, as phase 10 holds PageRank: a
# bound on max |d| alone passes an exchange that loses the low-rank
# vertices, whose ranks sit far below 2e-2 of the largest.  fp32 is phase
# 10's float32 budget; bf16 and int8 are a few times the readings of the
# scale-22 stream on an H100 (PERF.md, phase 11).
DIST_REL_L1 = {"fp32": PR_REL_L1, "bf16": 1e-3, "int8": 1e-2}


def _dist_rank(rank, n_ranks, workdir, batch_cap, seed, device):
    """One rank of phase 11, in a process of its own: distributed PageRank
    with each exchange on its shard on the card, the reduce's kernel
    against its plain version (rank 0, outside the counts), and its share
    of the stream through the mesh write router, held against the host
    router.  ``device`` is the card (``"cuda:0"``), or ``"cpu"`` for a
    rehearsal, where no kernel launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import (EXCHANGES, ShardedCSR,
                                              make_distributed_pagerank)
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.shard import (RangePartition, bucket_edge_batches,
                                   make_mesh_write_router)
    wd = Path(workdir)
    meta = json.loads((wd / "meta.json").read_text())
    dev = torch.device(device)
    mesh = make_shard_mesh(n_ranks, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def load(name):
        return np.load(wd / f"{name}.npy", mmap_mode="r")
    shard = ShardedCSR(dst=load("dst"), seg=load("seg"), wt=load("wt"),
                       deg=load("deg"), v_start=load("v_start"),
                       n_vertices=meta["n_vertices"], n_shards=n_ranks)
    refs = {w: np.load(wd / f"pr_{w}.npy") for w in DIST_WITNESSES}
    n = meta["n_vertices"]
    out = {}
    # Warm-up, not counted: the kernel library's load and first launch.
    make_distributed_pagerank(mesh, shard, iters=1)()
    ops.reset_launches()
    pr = {}
    for ex in EXCHANGES:
        run = make_distributed_pagerank(mesh, shard, iters=DIST_ITERS,
                                        exchange=ex)
        staged0 = mesh.staged_bytes
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        x = run()
        sync()
        secs = time.perf_counter() - t0
        x = x.cpu().numpy()
        pr[ex] = dict(ms_per_iter=secs * 1e3 / DIST_ITERS,
                      err={w: float(np.abs(x[:n] - r).max() / r.max())
                           for w, r in refs.items()},
                      rel_l1={w: float(np.abs(x[:n] - r).sum()
                                       / np.abs(r).sum())
                              for w, r in refs.items()},
                      finite=bool(np.isfinite(x).all()),
                      pads_zero=bool((x[n:] == 0).all()),
                      staged_bytes=mesh.staged_bytes - staged0)
    out["pagerank"] = pr
    out["launches"] = ops.launch_counts()
    if rank == 0 and dev.type == "cuda":
        # The reduce's kernel at this shard's shapes, on integer inputs
        # (every partial sum exact in any order), as phase 4 checks it.
        local = shard.local(rank, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 29)
        e, vl = local.dst.shape[0], local.v_local
        choice = torch.tensor([1.0, -1.0, 0.0, 2.0], device=dev)
        wt = choice[torch.randint(0, 4, (e,), generator=gen, device=dev)]
        x = torch.randint(-2, 3, (n_ranks * vl,), generator=gen,
                          device=dev).float()
        got = sr.gather_segsum_cuda(local.dst, local.seg_id, wt, x, vl)
        want = sr.gather_segsum_ref(local.dst, local.seg_id, wt, x, vl)
        torch.cuda.synchronize(dev)
        out["kernel"] = dict(
            shape=f"E={e} edges, n_out={vl}, len(x)={x.shape[0]}",
            max_abs_err=float((got - want).abs().max()),
            ok=bool(torch.allclose(got, want, rtol=SEG_RTOL, atol=SEG_ATOL)),
            ms=time_ms(lambda: sr.gather_segsum_cuda(
                local.dst, local.seg_id, wt, x, vl)),
            plain_ms=time_ms(lambda: sr.gather_segsum_ref(
                local.dst, local.seg_id, wt, x, vl), iters=3, warmup=1))
        del local, wt, x, got, want

    # Routing: batch b goes in round b // n_ranks from rank b % n_ranks.
    src, dst, prop, ins = (load(k) for k in ("s_src", "s_dst", "s_prop",
                                              "s_ins"))
    offs = np.load(wd / "s_offs.npy")
    nb = len(offs) - 1
    part = RangePartition.for_vmax(meta["vmax"], n_ranks)
    router = make_mesh_write_router(mesh, part, bucket_cap=batch_cap)
    staged0 = mesh.staged_bytes
    sent = dropped = 0
    kept = []

    def col(a, lo, hi, dtype):
        buf = np.zeros(batch_cap, dtype)
        buf[:hi - lo] = a[lo:hi]
        return torch.from_numpy(buf).to(dev)
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    for b0 in range(0, nb, n_ranks):
        b = b0 + rank
        lo, hi = (int(offs[b]), int(offs[b + 1])) if b < nb else (0, 0)
        rs, rd, rp, rm, rv, drop = router(
            col(src, lo, hi, np.int32), col(dst, lo, hi, np.int32),
            col(prop, lo, hi, np.float32),
            col(~np.asarray(ins[lo:hi]), 0, hi - lo, np.int32), hi - lo)
        keep = rv.bool()
        kept.append(torch.stack([rs, rd, rp.view(torch.int32), rm])[:, keep])
        sent += hi - lo
        dropped += int(drop[0])
    sync()
    route_s = time.perf_counter() - t0
    got = torch.cat(kept, dim=1).cpu().numpy()
    del kept
    # The host router on the same batches, in the same order.
    want = [[], [], [], []]
    for b in range(nb):
        lo, hi = int(offs[b]), int(offs[b + 1])
        bucket = bucket_edge_batches(part, src[lo:hi], dst[lo:hi],
                                     prop[lo:hi])[rank]
        if bucket is None:
            continue
        marker = 0 if bool(ins[lo]) else 1
        want[0].append(bucket[0])
        want[1].append(bucket[1])
        want[2].append(bucket[2].view(np.int32))
        want[3].append(np.full(len(bucket[0]), marker))
    want = np.stack([np.concatenate(w).astype(np.int32) for w in want])
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (got.shape, want.shape) if got.shape != want.shape else \
            int((got != want).any(axis=0).sum())
        raise AssertionError(f"rank {rank}: the mesh write router's records "
                             f"differ from the host router's: {bad}")
    if not (got[0] // part.v_local == rank).all():
        raise AssertionError(f"rank {rank}: a record of another owner")
    out["routing"] = dict(sent=sent, received=int(got.shape[1]),
                          dropped=dropped, secs=route_s,
                          markers=int(got[3].sum()),
                          rounds=-(-nb // n_ranks),
                          staged_bytes=mesh.staged_bytes - staged0)
    return out


def distributed_path(dev, oracle, stream, seed, batch_cap, smi="",
                     log=print):
    """Phase 11: the distributed graph layer on the card.  The oracle's CSR
    (phase 3's whole stream) is partitioned over 4 shards; 4 ranks
    (spawned processes joined by gloo, each shard on this card) run
    distributed PageRank with each exchange and route phase 3's batches
    through the mesh write router."""
    import shutil
    import tempfile

    import torch
    from repro_torch.analytics import pagerank
    from repro_torch.analytics.view import CSRView
    from repro_torch.core.distributed import EXCHANGES, partition_csr
    from repro_torch.launch.mesh import spawn_ranks
    t_phase = time.perf_counter()
    voff, dst, _ = oracle
    n = len(voff) - 1
    view = CSRView(voff=torch.from_numpy(voff.astype(np.int32)).to(dev),
                   dst=torch.from_numpy(dst.astype(np.int32)).to(dev),
                   prop=torch.ones(len(dst), device=dev), n_vertices=n,
                   n_edges=len(dst))
    with _uncounted():
        refs = dict(card=pagerank(view, iters=DIST_ITERS).cpu().numpy())
    refs["f64"] = pagerank_f64(voff, dst, DIST_ITERS)
    t0 = time.perf_counter()
    shard = partition_csr(view, DIST_RANKS)
    del view
    t_part = time.perf_counter() - t0
    sizes = np.asarray(stream["sizes"], np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    if sizes.max() > batch_cap:
        raise AssertionError(f"a batch of {sizes.max()} records, above "
                             f"batch_cap {batch_cap}")
    root = tempfile.mkdtemp(prefix="lsmg-dist-")
    try:
        t0 = time.perf_counter()
        for name in ("dst", "seg", "wt", "deg", "v_start"):
            np.save(Path(root) / f"{name}.npy", getattr(shard, name))
        for w, ref in refs.items():
            np.save(Path(root) / f"pr_{w}.npy", ref)
        for k, dt in (("src", np.int32), ("dst", np.int32),
                      ("prop", np.float32), ("ins", np.bool_)):
            np.save(Path(root) / f"s_{k}.npy", stream[k].astype(dt))
        np.save(Path(root) / "s_offs.npy", offs)
        (Path(root) / "meta.json").write_text(json.dumps(
            dict(n_vertices=n, vmax=n)))
        t_save = time.perf_counter() - t0
        log(f"distributed: {shard.n_shards} shards of {shard.v_local} "
            f"vertices, edges {[int(np.count_nonzero(w)) for w in shard.wt]}"
            f"; partition {t_part:.1f} s, files {t_save:.1f} s")
        del shard
        t0 = time.perf_counter()
        ranks = spawn_ranks(_dist_rank, DIST_RANKS, root, batch_cap, seed,
                            str(dev), timeout=600)
        t_ranks = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    want = DIST_RANKS * DIST_ITERS * len(EXCHANGES)
    each = [r["launches"]["gather_segsum"] for r in ranks]
    if dev.type == "cuda" and \
            each != [DIST_ITERS * len(EXCHANGES)] * DIST_RANKS:
        raise AssertionError(f"gather_segsum launched {each} times by rank, "
                             f"want {DIST_ITERS * len(EXCHANGES)} each "
                             f"({want} in all)")
    pr = {}
    for ex in EXCHANGES:
        if not all(r["pagerank"][ex]["finite"] and
                   r["pagerank"][ex]["pads_zero"] for r in ranks):
            raise AssertionError(f"{ex}: a rank's PageRank is not finite or "
                                 f"its pads are not 0")
        err = {w: max(r["pagerank"][ex]["err"][w] for r in ranks)
               for w in DIST_WITNESSES}
        l1 = {w: max(r["pagerank"][ex]["rel_l1"][w] for r in ranks)
              for w in DIST_WITNESSES}
        for w in DIST_WITNESSES:
            if not err[w] < DIST_BOUND[ex]:
                raise AssertionError(
                    f"{ex}: distributed PageRank differs from the {w} "
                    f"witness by {err[w]} of its largest rank (bound "
                    f"{DIST_BOUND[ex]})")
            if not l1[w] <= DIST_REL_L1[ex]:
                raise AssertionError(
                    f"{ex}: distributed PageRank differs from the {w} "
                    f"witness by relative L1 {l1[w]} (bound "
                    f"{DIST_REL_L1[ex]})")
        pr[ex] = dict(err=err, rel_l1=l1, ms_per_iter=max(
            r["pagerank"][ex]["ms_per_iter"] for r in ranks),
            staged_bytes=sum(r["pagerank"][ex]["staged_bytes"]
                             for r in ranks))
        how = "; ".join(f"{w}: max |d| / max(pr) {err[w]:.3e}, relative L1 "
                        f"{l1[w]:.3e}" for w in DIST_WITNESSES)
        log(f"distributed PageRank {ex}: {pr[ex]['ms_per_iter']:.2f} ms an "
            f"iteration (slowest rank, host clock, staged exchange "
            f"included); against {how} (bounds {DIST_BOUND[ex]} and "
            f"{DIST_REL_L1[ex]}); {pr[ex]['staged_bytes']} bytes staged "
            f"through the host [{smi}]")
    k = ranks[0].get("kernel")
    if dev.type == "cuda" and not (k and k["ok"]):
        raise AssertionError(f"gather_segsum on rank 0's shard differs from "
                             f"its plain version: {k}")
    if k:
        log(f"kernel gather_segsum (rank 0's shard, {k['shape']}): within "
            f"rtol {SEG_RTOL} / atol {SEG_ATOL} of plain (max abs err "
            f"{k['max_abs_err']}); {k['ms']:.3f} ms, plain "
            f"{k['plain_ms']:.3f} ms [{smi}]")
    rt = [r["routing"] for r in ranks]
    sent = sum(r["sent"] for r in rt)
    received = sum(r["received"] for r in rt)
    dropped = sum(r["dropped"] for r in rt)
    if sent != int(sizes.sum()) or received + dropped != sent or dropped:
        raise AssertionError(f"routing: sent {sent} of {int(sizes.sum())}, "
                             f"received {received}, dropped {dropped}")
    markers = sum(r["markers"] for r in rt)
    if markers != int((~stream["ins"]).sum()):
        raise AssertionError(f"routing: {markers} markers received, "
                             f"{int((~stream['ins']).sum())} sent")
    route_s = max(r["secs"] for r in rt)
    routing = dict(records=sent, rounds=rt[0]["rounds"], secs=route_s,
                   records_per_s=sent / route_s, markers=markers,
                   staged_bytes=sum(r["staged_bytes"] for r in rt),
                   dropped=dropped)
    log(f"distributed routing: {sent} records in {routing['rounds']} rounds "
        f"of {DIST_RANKS} batches, {routing['records_per_s']:.0f} records/s "
        f"(slowest rank, host clock), {routing['staged_bytes']} bytes "
        f"staged through the host; every shard's records equal the host "
        f"router's, dropped 0 [{smi}]")
    wall = time.perf_counter() - t_phase
    log(f"distributed phase: {wall:.1f} s wall, ranks {t_ranks:.1f} s "
        f"[{smi}]")
    return dict(pagerank=pr, routing=routing, launches=launches,
                kernel=k, wall_s=wall, ranks_s=t_ranks)


# ------------------------------------------------------------------ phase 12
# Qwen2-1.5B (src/repro_torch/configs/qwen2_1_5b.py: 28 layers, d_model
# 1,536, 12 query heads over 2 kv heads, head_dim 128, vocab 151,936, tied
# embeddings, QKV bias) at full width with random bfloat16 weights.  Two
# requests (batch, prompt, decode steps): A takes full_attention, B has
# 16,384 keys (> 8,192) and takes chunked_attention (layers.py:171 of the
# reference).
SERVE_ARCH = "qwen2-1.5b"
SERVE_REQUESTS = {"A": (4, 512, 32), "B": (1, 16384, 8)}
# (a) decode after prefill(t[:k]) against prefill(t[:k+1]): the
# reference's own tolerance for it (tests/test_models_smoke.py:86-88,
# float32 weights over a bfloat16 cache).
SERVE_DECODE_TOL = dict(rtol=2e-2, atol=2e-2)
# (b) request A's bfloat16 prefill logits against the float32 copy's:
# relative L1 (sum |got - want| / sum |want|).
SERVE_BF16_L1 = 5e-2
# (c) one reduced config of each family, prefill and 4 decode steps on the
# card against the port on the CPU, float32 weights and a float32 cache.
# With the reference's bfloat16 cache a decode step rounds each new
# token's k/v (or conv input) and reads it back, and one rounding that
# falls the other way on the card moved jamba's logits to 0.985 of this
# limit on an NVIDIA H100 80GB HBM3 (PERF.md).
SERVE_FAMILIES = ("qwen2-1.5b", "deepseek-v2-236b", "arctic-480b",
                  "jamba-v0.1-52b", "mamba2-2.7b", "whisper-small",
                  "internvl2-26b")
SERVE_FAMILY_TOL = dict(rtol=1e-3, atol=1e-3)
SERVE_FAMILY_STEPS = 4
# (d) flash_attention on layer 0's q, k, v of request A against the
# model's own full_attention, whose logits are rounded to bfloat16 (up to
# 2^-9 of each logit): relative L1 of the outputs.
SERVE_ATTN_L1 = 2e-2


def _rel_l1(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().sum() / want.abs().sum().clamp_min(1e-30))


def _cache_map(fn, cache):
    """A decode cache (``repro_torch.models``' layout) with ``fn`` applied
    to every tensor."""
    out = {"layers": [{k: fn(v) for k, v in c.items()}
                      for c in cache["layers"]]}
    if "cross" in cache:
        out["cross"] = [{k: fn(v) for k, v in c.items()}
                        for c in cache["cross"]]
    return out


def _cache_close(got, want, tol, what: str) -> float:
    """Every tensor of cache ``got`` within ``tol`` of ``want``'s; the
    largest share of that limit."""
    worst = 0.0
    for i, (cg, cw) in enumerate(zip(got["layers"] + got.get("cross", []),
                                     want["layers"] + want.get("cross",
                                                               []))):
        for k in cw:
            g, w = cg[k].float().cpu(), cw[k].float().cpu()
            d = (g - w).abs()
            lim = tol["atol"] + tol["rtol"] * w.abs()
            share = float((d / lim).max()) if d.numel() else 0.0
            if share > 1.0:
                raise AssertionError(f"{what}: cache entry {i} {k} differs: "
                                     f"max abs err {float(d.max()):.3e}")
            worst = max(worst, share)
    return worst


def family_batch(cfg, seed, dev, prompt: int = 16, batch: int = 2):
    """Tokens and, for a frontend, float32 stub embeddings from one NumPy
    generator (the reference's smoke tests use float32 frontends)."""
    import torch
    from repro_torch.launch.serve import FRONTEND_LEN
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab, (batch, prompt)).astype(np.int32)).to(dev)}
    n_front = FRONTEND_LEN.get(cfg.frontend)
    if n_front:
        out["frontend"] = torch.from_numpy(rng.normal(
            0, 1, (batch, n_front, cfg.d_model)).astype(np.float32)).to(dev)
    return out


def check_family_on_card(arch, dev, seed, steps=SERVE_FAMILY_STEPS,
                         tol=SERVE_FAMILY_TOL):
    """Phase 12 (c) for one architecture: its reduced config with float32
    weights and cache, prefill then ``steps`` greedy decode steps on the
    card against the same model on the CPU.  Each decode step starts both
    from the CPU's cache before it.  Returns the largest share of the
    limit seen (logits and caches)."""
    import copy
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve
    from repro_torch.models import Model, decode_step, prefill
    cfg = reduced_config(arch)
    cpu = Model(cfg, dtype=torch.float32, device="cpu", seed=seed)
    card = copy.deepcopy(cpu).to(dev)
    batch = family_batch(cfg, seed, "cpu")
    pos = serve.prompt_positions(cfg, batch)
    s_max = pos + steps + 1
    want, c_cpu = prefill(cfg, cpu, batch, s_max=s_max,
                          cache_dtype=torch.float32)
    got, c_card = prefill(cfg, card, {k: v.to(dev) for k, v in batch.items()},
                          s_max=s_max, cache_dtype=torch.float32)
    worst = _cache_close(c_card, c_cpu, tol, f"{arch} prefill")

    def logits_share(got, want, what):
        d = (got.cpu() - want).abs()
        share = float((d / (tol["atol"] + tol["rtol"] * want.abs())).max())
        if share > 1.0:
            raise AssertionError(f"{what}: logits differ from the CPU's: max "
                                 f"abs err {float(d.max()):.3e}")
        return share

    worst = max(worst, logits_share(got, want, f"{arch} prefill"))
    for i in range(steps):
        tok = want.argmax(-1)
        c_card = _cache_map(lambda t: t.to(dev, copy=True), c_cpu)
        want, c_cpu = decode_step(cfg, cpu, c_cpu, tok, pos + i)
        got, c_card = decode_step(cfg, card, c_card, tok.to(dev), pos + i)
        worst = max(worst, logits_share(got, want, f"{arch} step {i}"),
                    _cache_close(c_card, c_cpu, tol, f"{arch} step {i}"))
    return worst


def serving_bounds(cfg, model, b, p, g):
    """The least time the card could take for a request's prefill and for
    one decode step, in ms (the larger of bytes over the memory rate and
    operations over the peak rate, per part): the prefill's projections
    on bf16 tensor cores (2 x the block weights x tokens, plus the last
    token's logits), its attention scores and sums (all key pairs, as the
    model computes them: bf16 in full_attention, float32 without TF32 in
    chunked_attention); a decode step reads every weight once and each
    layer's k/v cache up to the step's position."""
    blocks = sum(q.numel() for q in model.blocks.parameters())
    w_bytes = sum(q.numel() * q.element_size() for q in model.parameters())
    hq, hkv, hd, layers = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_layers
    proj = 2.0 * blocks * b * p + 2.0 * b * cfg.d_model * model.embed.shape[0]
    attn = 4.0 * b * hq * p * p * hd * layers
    attn_rate = FP32_FLOPS if p > 8192 else BF16_TC_FLOPS
    pf_ms = proj / BF16_TC_FLOPS * 1e3 + attn / attn_rate * 1e3
    pf_ms = max(pf_ms, (w_bytes + 2 * b * p * layers * hkv * hd * 2)
                / HBM_BYTES_PER_S * 1e3)
    kv_bytes = 2 * b * (p + g / 2) * layers * hkv * hd * 2
    dec_ms = max((w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
                 2.0 * (blocks + model.embed.numel()) * b / BF16_TC_FLOPS
                 * 1e3)
    return pf_ms, dec_ms


def flash_on_activations(cfg, model, toks, smi="", log=print):
    """Phase 12 (d): layer 0's post-RoPE q, k and v of ``toks``' prefill,
    laid out [B, H, S, D], through ``ops.attention(use_pallas=True,
    causal=True, scale=hd ** -0.5)``: held against the plain version on
    float32-upcast inputs (phase 6's bf16 check; on the card only, where
    the kernel runs) and against the model's own ``full_attention``
    (relative L1 under SERVE_ATTN_L1).  On the card the call must launch
    ``flash_attention`` once, on the tensor cores, and the kernel is timed
    beside the model's attention (not counted)."""
    import torch
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    dev = toks.device
    on_card = dev.type == "cuda"
    blk = model.blocks[0]
    s = toks.shape[1]
    scale = cfg.hd ** -0.5
    with torch.inference_mode():
        pos = torch.arange(s, dtype=torch.int32, device=dev)
        q, kk, v = blk.attn.qkv(blk.norm1(model.embed[toks.long()],
                                          cfg.norm_eps), pos)
        model_o = L.full_attention(q, kk, v, pos, pos, causal=True,
                                   window=0, scale=scale)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, kk, v))
    before = ops.launch_counts()
    paths_before = dict(flash.flash_attention_cuda.path_launches)
    o = ops.attention(qh, kh, vh, causal=True, scale=scale, use_pallas=True)
    if on_card:
        torch.cuda.synchronize(dev)
    took = {n: c - before[n] for n, c in ops.launch_counts().items()
            if c != before[n]}
    path = [n for n, c in flash.flash_attention_cuda.path_launches.items()
            if c != paths_before[n]]
    plain = flash.mha_ref(qh.float(), kh.float(), vh.float(), causal=True,
                          scale=scale)
    err, ratio, ok = bf16_check(o.float(), plain)
    l1 = _rel_l1(o.float(), model_o.transpose(1, 2).float())
    res = dict(shape=f"B={qh.shape[0]} Hq={qh.shape[1]} Hkv={kh.shape[1]} "
                     f"S={s} D={qh.shape[3]} bf16 causal",
               max_abs_err=err, limit_share=ratio, rel_l1_vs_model=l1,
               launches=took, kernel_path=path)
    # On the CPU ops.attention is the plain version in bfloat16.
    if on_card and not ok:
        raise AssertionError(f"(d) flash_attention on the model's "
                             f"activations differs from plain: max abs err "
                             f"{err:.3e}, {ratio:.2f} of the limit")
    if not l1 < SERVE_ATTN_L1:
        raise AssertionError(f"(d) flash_attention against the model's "
                             f"full_attention: relative L1 {l1:.3e}")
    if not on_card:
        return res
    if took != {"flash_attention": 1} or path != ["tensor_cores"]:
        raise AssertionError(f"(d) ops.attention launched {took} on {path}, "
                             f"not flash_attention once on the tensor cores")
    with _uncounted():
        ms = time_ms(lambda: flash.flash_attention_cuda(
            qh, kh, vh, causal=True, scale=scale), iters=20)
        with torch.inference_mode():
            model_ms = time_ms(lambda: L.full_attention(
                q, kk, v, pos, pos, causal=True, window=0, scale=scale),
                iters=20)
    b, hq, _, d = qh.shape
    t_bound, by = bound(2 * (2 * qh.numel() + kh.numel() + vh.numel()),
                        4 * b * hq * s * s * d / 2, BF16_TC_FLOPS)
    res.update(ms=ms, model_ms=model_ms, bound_ms=t_bound, bound_by=by)
    log(f"serving (d): flash_attention on layer 0's activations "
        f"({res['shape']}, GQA ratio {cfg.n_heads // cfg.n_kv_heads}): "
        f"{ms:.4f} ms (bound {t_bound:.4f} ms, {by}) against the model's "
        f"torch-op full_attention {model_ms:.4f} ms; max abs err {err:.3e} against the float32 "
        f"plain version ({ratio:.2f} of the scaled limit), relative L1 "
        f"{l1:.3e} against the model's output [{smi}]")
    return res


def serving_path(dev, seed, smi="", reduced=False, log=print):
    """Phase 12: Qwen2-1.5B served through ``repro_torch.launch.serve``'s
    functions (requests A and B), then checks (a) to (d).  ``reduced``
    runs the same on the reduced config with small requests (a rehearsal
    on the CPU, where (c) and the launch checks are skipped)."""
    import copy
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import serve
    from repro_torch.models import Model, decode_step, prefill
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    cfg = (reduced_config if reduced else get_config)(SERVE_ARCH)
    requests = ({"A": (4, 128, 4), "B": (1, 256, 2)} if reduced
                else SERVE_REQUESTS)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=seed)
    sync()
    out = {"arch": SERVE_ARCH, "reduced": reduced,
           "params": sum(q.numel() for q in model.parameters()),
           "weight_bytes": sum(q.numel() * q.element_size()
                               for q in model.parameters()),
           "init_s": time.perf_counter() - t0}
    log(f"serving: {SERVE_ARCH}{' (reduced)' if reduced else ''}, "
        f"{out['params']} parameters ({out['weight_bytes'] / 1e9:.3f} GB "
        f"bf16) made on {dev} in {out['init_s']:.2f} s")
    # Untimed warm-up: cuBLAS handles, the allocator's first blocks.
    serve.serve(cfg, model, serve.make_batch(cfg, 1, 16, seed, dev), 2,
                s_max=18)
    kept = {}
    for i, (name, (b, p, g)) in enumerate(requests.items()):
        batch = serve.make_batch(cfg, b, p, seed + 1 + i, dev)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        res = serve.serve(cfg, model, batch, g, s_max=p + g + 8)
        logits = res.pop("prefill_logits")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"request {name}: non-finite logits")
        toks = res["tokens"]
        if toks.shape != (b, g) or toks.min() < 0 or toks.max() >= cfg.vocab:
            raise AssertionError(f"request {name}: tokens {toks.shape}, "
                                 f"range [{toks.min()}, {toks.max()}]")
        pf_bound, dec_bound = serving_bounds(cfg, model, b, p, g)
        r = dict(batch=b, prompt=p, gen=g,
                 attention="chunked" if p > 8192 else "full",
                 prefill_ms=res["prefill_s"] * 1e3,
                 prefill_tokens_per_s=b * p / res["prefill_s"],
                 decode_ms_per_step=res["decode_s"] / g * 1e3,
                 decode_tokens_per_s=b * g / res["decode_s"],
                 prefill_bound_ms=pf_bound, decode_bound_ms=dec_bound,
                 peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                           if on_card else None),
                 sample=toks[0][:8].tolist())
        out[name] = r
        log(f"serving request {name}: batch {b} x prompt {p} "
            f"({r['attention']} attention): prefill {r['prefill_ms']:.3f} ms "
            f"({r['prefill_tokens_per_s']:.0f} tokens/s, bound "
            f"{pf_bound:.3f} ms); {g} decode steps at "
            f"{r['decode_ms_per_step']:.3f} ms a step "
            f"({r['decode_tokens_per_s']:.1f} tokens/s, bound "
            f"{dec_bound:.3f} ms); peak device memory "
            f"{r['peak_gib'] if r['peak_gib'] is None else round(r['peak_gib'], 3)}"
            f" GiB [{smi}]")
        if name == "A":
            kept = dict(batch=batch, logits=logits)
            if on_card:
                # The device's share of a decode step: torch.profiler over
                # 5 more steps at the next free position (each rewrites it).
                tok = torch.from_numpy(toks[:, -1]).to(dev)
                by_kernel = {}
                busy = device_ms(lambda: decode_step(
                    cfg, model, res["cache"], tok, p + g), iters=5,
                    by_kernel=by_kernel)
                r.update(decode_device_ms=busy,
                         decode_kernels=sum(n for n, _ in by_kernel.values()),
                         decode_device_share=busy / r["decode_ms_per_step"])
                log(f"serving request A: a decode step keeps the device "
                    f"busy {busy:.3f} ms of {r['decode_ms_per_step']:.3f} "
                    f"ms ({r['decode_device_share']:.3f}) over "
                    f"{r['decode_kernels']:.0f} kernels (torch.profiler) "
                    f"[{smi}]")
        del res, logits

    # (a) and (b): a float32 copy of the same weights.
    f32 = copy.deepcopy(model).float()
    toks = kept["batch"]["tokens"]
    k = toks.shape[1] - 1
    full, _ = prefill(cfg, f32, {"tokens": toks})
    _, cache = prefill(cfg, f32, {"tokens": toks[:, :k]}, s_max=k + 1)
    step, _ = decode_step(cfg, f32, cache, toks[:, k], k)
    del cache
    err_a = float((step - full).abs().max())
    if not torch.allclose(step, full, **SERVE_DECODE_TOL):
        raise AssertionError(f"(a) decode after prefill({k}) differs from "
                             f"prefill({k + 1}): max abs err {err_a:.3e}")
    l1_b = _rel_l1(kept["logits"].float(), full)
    if not l1_b < SERVE_BF16_L1:
        raise AssertionError(f"(b) bf16 prefill logits against float32: "
                             f"relative L1 {l1_b:.3e}")
    out["decode_vs_prefill_max_abs_err"] = err_a
    out["bf16_vs_f32_rel_l1"] = l1_b
    log(f"serving (a): float32 decode after prefill({k}) against "
        f"prefill({k + 1}): max abs err {err_a:.3e} (rtol = atol = 2e-2); "
        f"(b) request A's bf16 prefill logits against float32: relative L1 "
        f"{l1_b:.3e} (limit {SERVE_BF16_L1})")
    del f32, full, step

    # (c): every family, card against CPU.
    if on_card:
        out["families"] = {a: check_family_on_card(a, dev, seed)
                           for a in SERVE_FAMILIES}
        log(f"serving (c): prefill + {SERVE_FAMILY_STEPS} decode steps of "
            f"each family on the card against the CPU, largest share of "
            f"rtol = atol = 1e-3: {out['families']}")

    # (d): flash_attention on layer 0's post-RoPE q, k, v of request A.
    out["attention"] = flash_on_activations(cfg, model, toks, smi, log)
    return out


# ------------------------------------------------------------------ phase 13
# Qwen2-1.5B trained at full width and depth (28 layers, d_model 1,536,
# 1,543,714,304 parameters) with random bfloat16 weights and remat on, as
# its config sets it, at the sequence length of the train_4k shape of
# src/repro_torch/configs/base.py:176 (4,096 tokens).  The global batch is
# cut from train_4k's 256 to one card's share, 8 rows, in 4 micro-batches
# of 2: 32,768 tokens a step.
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4096, 8, 4, 4
# (a) step 0's loss: ln 151,936 = 11.93, raised by about half the
# logits' variance (a tied 0.02-scale embedding: standard deviation about
# 0.8).
TRAIN_LOSS0 = (11.0, 13.5)
# (b) one micro-batch with the bfloat16 weights against a float32 copy:
# the loss's relative difference and the relative L2 of all gradients.
TRAIN_BF16_LOSS_REL, TRAIN_BF16_GRAD_L2 = 1e-2, 1e-1
# (c) one reduced config of each family (SERVE_FAMILIES), float32: loss,
# gradients and one AdamW update at a fixed lr, card against CPU.  The
# update takes the CPU's gradients on both devices: Adam's first step moves
# a parameter by lr x g / (|g| + 1e-8), so a gradient within float32 noise
# of zero (about 1e-9 against partial sums of 1e-2) moves it by up to +-lr
# on either device, whatever the optimizer does.  With each device's own
# gradients jamba's update read 0.903 of this limit on an NVIDIA H100
# 80GB HBM3 (PERF.md).
TRAIN_FAMILY_TOL = dict(rtol=1e-3, atol=1e-3)
TRAIN_FAMILY_LR = 1e-3
# (d) the fault-tolerant loop through repro_torch.launch.train, reduced
# config, bfloat16 weights, in a child process with deterministic
# algorithms: steps, checkpoint interval, injected failures.
REPLAY_STEPS, REPLAY_EVERY, REPLAY_FAILS = 12, 4, (5, 9)
REPLAY_FROM = 8     # the losses from this step on must equal the clean run's


def training_bound(cfg, model, n_seq: int, seq: int):
    """One step's FLOPs and least time on the card.  The products: every
    block weight matrix and the tied head (vocab x d) twice a token forward
    and four times backward, and the blocks' forward once more for remat;
    attention's two S x S products (all key pairs, as full_attention
    computes them) 4 x B x Hq x S^2 x hd a layer forward, twice that
    backward, once more for remat; all on bf16 tensor cores.  The bytes:
    the weights read and written, the float32 moments and gradient
    accumulators each read and written once.  -> (flops, ms, bound_by)."""
    mats = sum(p.numel() for p in model.blocks.parameters() if p.dim() >= 2)
    head = model.embed.numel()
    tokens = n_seq * seq
    proj = (6.0 * (mats + head) + 2.0 * mats) * tokens
    attn = 16.0 * n_seq * cfg.n_heads * seq * seq * cfg.hd * cfg.n_layers
    n = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    ms, by = bound(2 * w_bytes + 3 * 2 * 4 * n, proj + attn, BF16_TC_FLOPS)
    return proj + attn, ms, by


def _share(got, want, tol, what: str) -> float:
    """The largest share of ``|got - want| <= atol + rtol |want|`` over
    the elements (raises past 1)."""
    d = (got.detach().float().cpu() - want.detach().float()).abs()
    share = float((d / (tol["atol"] + tol["rtol"] * want.detach().float()
                        .abs())).max()) if d.numel() else 0.0
    if not share <= 1.0:
        raise AssertionError(f"{what}: card differs from the CPU: max abs "
                             f"err {float(d.max()):.3e}")
    return share


def check_train_family_on_card(arch, dev, seed, tol=TRAIN_FAMILY_TOL):
    """Phase 13 (c) for one architecture: its reduced config with float32
    weights, ``loss`` and its gradients on one batch, on the card and on
    the CPU from the same weights; then one ``adamw_update`` at lr
    TRAIN_FAMILY_LR on each device, of the CPU's gradients (see
    TRAIN_FAMILY_TOL).  Returns the largest share of the limit seen (the
    loss, every gradient, every updated parameter)."""
    import copy
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.models import Model, loss
    from repro_torch.optim import accumulate_grads, adamw_init, adamw_update
    cfg = reduced_config(arch)
    cpu = Model(cfg, dtype=torch.float32, device="cpu", seed=seed)
    card = copy.deepcopy(cpu).to(dev)
    batch = family_batch(cfg, seed, "cpu")
    out = {}
    for name, m, b in (("cpu", cpu, batch),
                       ("card", card, {k: v.to(dev)
                                       for k, v in batch.items()})):
        out[name] = accumulate_grads(lambda m_, b_: loss(cfg, m_, b_), m, b,
                                     1)
    grads = out["cpu"][1]
    adamw_update(cpu, grads, adamw_init(cpu), lr=TRAIN_FAMILY_LR)
    adamw_update(card, {k: g.to(dev) for k, g in grads.items()},
                 adamw_init(card), lr=TRAIN_FAMILY_LR)
    worst = _share(out["card"][0], out["cpu"][0], tol, f"{arch} loss")
    for k, g in out["cpu"][1].items():
        worst = max(worst, _share(out["card"][1][k], g, tol,
                                  f"{arch} gradient {k}"))
    for (k, p), q in zip(cpu.named_parameters(), card.parameters()):
        worst = max(worst, _share(q, p, tol, f"{arch} updated {k}"))
    return worst


def _npz_members(path):
    import zipfile
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


def train_replay(device: str, seed: int, workdir: str) -> dict:
    """Phase 13 (d), in its own process (``--train-replay``): the caller
    sets ``CUBLAS_WORKSPACE_CONFIG`` and this turns on deterministic
    algorithms before the first CUDA op.  ``repro_torch.launch.train``'s
    ``main`` runs reduced qwen2-1.5b (bfloat16) for REPLAY_STEPS steps with a
    checkpoint every REPLAY_EVERY, once clean and once with failures at
    REPLAY_FAILS; the faulty run must restart twice, every bfloat16 leaf of
    its checkpoints must restore as bfloat16, and its losses from step
    REPLAY_FROM and its final checkpoint (the manifest, and every member of
    every shard, whose zip entries also record their write time) must be
    the clean run's, byte for byte."""
    import os
    import torch
    torch.use_deterministic_algorithms(True)
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import reduced_config
    from repro_torch.launch import train
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    runs = {}
    for name, fails in (("clean", ()), ("faulty", REPLAY_FAILS)):
        argv = ["--reduced", "--steps", str(REPLAY_STEPS), "--ckpt-every",
                str(REPLAY_EVERY), "--ckpt-dir", os.path.join(workdir, name),
                "--device", device, "--seed", str(seed)]
        if fails:
            argv += ["--fail-at", *map(str, fails)]
        runs[name] = train.main(argv)
    clean, faulty = runs["clean"], runs["faulty"]
    if (clean.restarts, faulty.restarts) != (0, len(REPLAY_FAILS)):
        raise AssertionError(f"restarts {clean.restarts} and "
                             f"{faulty.restarts}, not 0 and "
                             f"{len(REPLAY_FAILS)}")
    losses = {s: (clean.metrics[s], faulty.metrics[s])
              for s in range(REPLAY_FROM, REPLAY_STEPS)}
    if any(a != b for a, b in losses.values()):
        raise AssertionError(f"losses after recovery differ: {losses}")
    final = f"step_{REPLAY_STEPS}"
    files = sorted(os.listdir(os.path.join(workdir, "clean", final)))
    for f in files:
        a, b = (os.path.join(workdir, run, final, f)
                for run in ("clean", "faulty"))
        same = (open(a, "rb").read() == open(b, "rb").read()
                if f.endswith(".json") else
                _npz_members(a) == _npz_members(b))
        if not same:
            raise AssertionError(f"final checkpoint {f} differs")
    # Each checkpoint the faulty run restored from, into a fresh template.
    cfg = reduced_config(TRAIN_ARCH)
    bf16 = 0
    for s in range(REPLAY_EVERY, REPLAY_STEPS, REPLAY_EVERY):
        model = Model(cfg, device=device, seed=seed + 1)
        (model, opt), _ = CheckpointManager(
            os.path.join(workdir, "faulty")).restore(
                (model, adamw_init(model)), step=s)
        kinds = {p.dtype for p in model.parameters()}
        if kinds != {torch.bfloat16}:
            raise AssertionError(f"step {s}: restored parameters {kinds}")
        bf16 += sum(1 for _ in model.parameters())
    return dict(restarts=faulty.restarts, losses_from_step=REPLAY_FROM,
                losses=[faulty.metrics[s] for s in range(REPLAY_STEPS)],
                final_files=files, bf16_leaves_restored=bf16,
                deterministic=torch.are_deterministic_algorithms_enabled())


def _replay_in_child(dev, seed, log):
    import os
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="lsmg-train-replay-")
    try:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--train-replay",
             work, "--device", str(dev), "--seed", str(seed)],
            capture_output=True, text=True, timeout=900,
            env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if out.returncode != 0:
        raise AssertionError(f"(d) the replay child failed:\n"
                             f"{out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"training (d) child: {line}")
    res = json.loads(lines[-1])
    res["child_s"] = secs
    return res


def _profiled_step(step_fn, model, opt, batch, dev):
    """One more train step under ``torch.profiler``: its wall ms (to a
    synchronise), the device's busy ms (every kernel's and copy's self
    time; one stream), the kernels launched and the 8 kernels (by name's
    first 60 characters) of most device time, as (name, launches, ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, opt, loss = step_fn(model, opt, batch)
        float(loss)
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    busy, n, by_name = 0.0, 0, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
            t = getattr(e, "self_device_time_total", None)
            t = (e.self_cuda_time_total if t is None else t) / 1e3
            busy += t
            n += e.count
            k0, t0 = by_name.get(e.key[:60], (0, 0.0))
            by_name[e.key[:60]] = (k0 + e.count, t0 + t)
    top = sorted(((k, c, t) for k, (c, t) in by_name.items()),
                 key=lambda r: -r[2])[:8]
    return model, opt, wall, busy, n, top


def training_path(dev, seed, smi="", reduced=False, log=print):
    """Phase 13: Qwen2-1.5B trained through ``repro_torch.launch.train``'s
    ``make_train_step`` (TRAIN_STEPS steps from ``TokenPipeline``), then
    checks (a) to (e).  ``reduced`` runs the same on the reduced config
    with 8 x 64-token batches (a rehearsal on the CPU, where (a)'s loss
    range and (c) are skipped and (e) compares the CPU with itself)."""
    import copy
    import math
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import Model, loss
    from repro_torch.optim import (accumulate_grads, adamw_init,
                                   compress_int8, decompress_int8)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    cfg = (reduced_config if reduced else get_config)(TRAIN_ARCH)
    seq = 64 if reduced else TRAIN_SEQ
    n_seq, n_micro = TRAIN_BATCH, TRAIN_MICRO
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=seed)
    sync()
    out = {"arch": TRAIN_ARCH, "reduced": reduced, "remat": cfg.remat,
           "params": sum(q.numel() for q in model.parameters()),
           "batch": n_seq, "seq": seq, "n_micro": n_micro,
           "init_s": time.perf_counter() - t0}
    flops, bound_ms, by = training_bound(cfg, model, n_seq, seq)
    out.update(step_flops=flops, step_bound_ms=bound_ms, bound_by=by)
    log(f"training: {TRAIN_ARCH}{' (reduced)' if reduced else ''}, "
        f"{out['params']} parameters (bf16) made on {dev} in "
        f"{out['init_s']:.2f} s; remat {cfg.remat}; {n_seq} x {seq} tokens "
        f"a step in {n_micro} micro-batches; bound {bound_ms:.1f} ms a step "
        f"({flops:.4e} FLOP, {by})")
    opt = adamw_init(model)
    step_fn = train.make_train_step(cfg, n_micro=n_micro)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=n_seq,
                         seed=seed)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for i in range(TRAIN_STEPS):
        batch = train.to_device(pipe.next_batch(), dev)
        sync()
        t0 = time.perf_counter()
        model, opt, ls = step_fn(model, opt, batch)
        ls = float(ls)
        sync()
        dt = time.perf_counter() - t0
        steps.append(dict(loss=ls, ms=dt * 1e3,
                          tokens_per_s=n_seq * seq / dt))
        log(f"training step {i}: loss {ls:.6f}, {dt * 1e3:.1f} ms "
            f"({n_seq * seq / dt:.0f} tokens/s; bound {bound_ms:.1f} ms) "
            f"[{smi}]")
        if not math.isfinite(ls):
            raise AssertionError(f"(a) step {i}: loss {ls}")
        if i == 0:
            lo, hi = TRAIN_LOSS0
            if not reduced and not lo <= ls <= hi:
                raise AssertionError(f"(a) step 0's loss {ls} is not in "
                                     f"[{lo}, {hi}]")
            moved = [n for n, p in model.named_parameters()
                     if not torch.equal(p, before[n])]
            if moved:
                raise AssertionError(f"(a) step 0 (lr 0) changed "
                                     f"{moved[:5]}")
            del before
    out["steps"] = steps
    if on_card:
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        batch = train.to_device(pipe.next_batch(), dev)
        model, opt, wall, busy, n, top = _profiled_step(step_fn, model, opt,
                                                        batch, dev)
        out.update(profiled_ms=wall, device_busy_ms=busy,
                   device_busy_share=busy / wall, profiled_kernels=n,
                   top_kernels=top)
        log(f"training: peak device memory {out['peak_gib']:.3f} GiB; a "
            f"profiled step keeps the device busy {busy:.1f} ms of "
            f"{wall:.1f} ms ({busy / wall:.3f}) over {n} kernels "
            f"(torch.profiler) [{smi}]")
        for name, count, ms in top:
            log(f"training: profiled step, {ms:.1f} ms in {count} launches "
                f"of {name}")

    # (b) One micro-batch, bfloat16 against a float32 copy of the weights.
    del opt, step_fn
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    mb = {k: v[:n_seq // n_micro]
          for k, v in train.to_device(pipe.next_batch(), dev).items()}

    def fn(m, b):
        return loss(cfg, m, b)

    l16, g16 = accumulate_grads(fn, model, mb, 1)
    f32 = copy.deepcopy(model).float()
    l32, g32 = accumulate_grads(fn, f32, mb, 1)
    del f32
    rel_loss = abs(float(l16) - float(l32)) / abs(float(l32))
    num = sum(float((g16[k].float() - g).double().square().sum())
              for k, g in g32.items())
    den = sum(float(g.double().square().sum()) for g in g32.values())
    rel_l2 = math.sqrt(num / den)
    del g32
    out.update(bf16_loss=float(l16), f32_loss=float(l32),
               bf16_loss_rel=rel_loss, bf16_grad_rel_l2=rel_l2)
    log(f"training (b): one micro-batch ({n_seq // n_micro} x {seq}), bf16 "
        f"loss {float(l16):.6f} against float32 {float(l32):.6f} (relative "
        f"{rel_loss:.3e}, limit {TRAIN_BF16_LOSS_REL}); relative L2 of all "
        f"gradients {rel_l2:.3e} (limit {TRAIN_BF16_GRAD_L2})")
    if not rel_loss < TRAIN_BF16_LOSS_REL:
        raise AssertionError(f"(b) bf16 loss against float32: relative "
                             f"{rel_loss:.3e}")
    if not rel_l2 < TRAIN_BF16_GRAD_L2:
        raise AssertionError(f"(b) bf16 gradients against float32: "
                             f"relative L2 {rel_l2:.3e}")

    # (e) int8 compression of that micro-batch's embed gradient.
    g = g16["embed"]
    del g16
    q, s = compress_int8(g)
    q_cpu, s_cpu = compress_int8(g.cpu())
    equal = (torch.equal(q.cpu(), q_cpu) and
             torch.equal(s.cpu().view(torch.int32), s_cpu.view(torch.int32)))
    back = decompress_int8(q, s, g.shape)
    err = float((back - g.float()).abs().max())
    lim = float(g.float().abs().max()) / 127
    out["int8"] = dict(shape=list(g.shape), byte_equal_to_cpu=equal,
                       decompress_max_abs_err=err, limit=lim)
    log(f"training (e): compress_int8 of the embed gradient "
        f"{tuple(g.shape)} on {dev} byte-equal to the CPU's: {equal}; "
        f"decompress max abs err {err:.3e} (limit max|g|/127 = {lim:.3e})")
    if not equal:
        raise AssertionError("(e) compress_int8 on the card differs from "
                             "the CPU's")
    if not err <= lim:
        raise AssertionError(f"(e) decompress_int8 error {err:.3e} over "
                             f"{lim:.3e}")
    del g, q, s, back, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # (c) Every family: loss, gradients and one update, card against CPU.
    if on_card:
        out["families"] = {a: check_train_family_on_card(a, dev, seed)
                           for a in SERVE_FAMILIES}
        log(f"training (c): loss, gradients and one AdamW update (lr "
            f"{TRAIN_FAMILY_LR}, the CPU's gradients) of each family on the "
            f"card against the CPU, largest share of rtol = atol = 1e-3: "
            f"{out['families']}")

    # (d) The fault-tolerant loop, deterministic, in a child process.
    out["replay"] = _replay_in_child(dev, seed, log)
    log(f"training (d): launch.train with failures at {REPLAY_FAILS}: "
        f"restarts {out['replay']['restarts']}, losses from step "
        f"{REPLAY_FROM} and the final checkpoint equal to the clean run's; "
        f"{out['replay']['bf16_leaves_restored']} bf16 leaves restored as "
        f"bf16 (child {out['replay']['child_s']:.1f} s)")
    return out


# ------------------------------------------------------------------ phase 14
# The dry run (src/repro_torch/launch/dryrun.py) held against the card.  Its
# "card" mesh is one H100 and no mesh: the step traced on fake CUDA tensors
# (FLOPs by FlopCounterMode's formulas, the peak by MemTracker).  (a) phase
# 13's training step, (b) phase 12's request A (prefill, then one decode
# step), each traced and then run for real from a reset peak twice: with no
# dispatch mode (its peak held to the trace's) and under FlopCounterMode's
# counting mode (its FLOPs held to the trace's, its peak printed); (c) the
# roofline terms of (a)'s trace beside phase 13's step and its hand bound;
# (d) single-pod cells traced on the host's CPU in child processes, which
# start first and run while (a) to (c) do.
DRYRUN_HOST_CELLS = (("qwen2-1.5b", "train_4k"),
                     ("deepseek-v2-236b", "prefill_32k"))
DRYRUN_CHILD_TIMEOUT = 240


def _host_dryruns():
    """Start (d)'s children: each cell, then the graph dry run, in a
    process of its own on the host's CPU, writing into a new temporary
    directory.  -> (the directory, [(name, process, start)])."""
    import os
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="dryrun-")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    cmds = [(f"{arch} x {shape} x single",
             ["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
              shape, "--mesh", "single", "--no-micro4"])
            for arch, shape in DRYRUN_HOST_CELLS]
    cmds.append(("lsmgraph-service x pagerank x single",
                 ["-m", "repro_torch.launch.graph_dryrun", "--mesh",
                  "single"]))
    children = []
    for i, (name, cmd) in enumerate(cmds):
        with open(Path(out_dir) / f"child{i}.log", "w") as log:
            children.append((name, subprocess.Popen(
                [sys.executable] + cmd + ["--device", "cpu", "--out",
                                          out_dir],
                env=env, stdout=log, stderr=subprocess.STDOUT),
                time.perf_counter()))
    return out_dir, children


def _measured_step(dev, fn, count: bool = True):
    """``fn()`` on the card from a reset peak, under FlopCounterMode's own
    counting mode when ``count``: -> (its result, FLOPs or None, the peak
    allocated bytes).  The counting mode runs without FlopCounterMode's
    module tracker, whose backward hooks hold tensors to the step's end
    (a whole FlopCounterMode over phase 13's step ran out of the card's
    80 GB)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    counter = FlopCounterMode(display=False)
    with _FlopCounterMode(counter) if count else contextlib.nullcontext():
        out = fn()
    torch.cuda.synchronize(dev)
    return (out, counter.get_total_flops() if count else None,
            torch.cuda.max_memory_allocated(dev))


def _held(name, trace, plain_peak, flops, counted_peak, log, smi,
          tol):
    """(a)/(b): the trace's peak within ``tol`` of the plain step's, and
    its FLOPs equal the counted step's.  ``counted_peak`` is the counted
    step's peak (reported).  -> a row."""
    rel = (trace.peak - plain_peak) / plain_peak
    row = dict(what=name, trace_flops=trace.flops, measured_flops=flops,
               trace_peak_gib=trace.peak / 2**30,
               measured_peak_gib=plain_peak / 2**30, peak_rel_err=rel,
               counted_peak_gib=counted_peak / 2**30)
    log(f"dry run (card) {name}: FLOPs traced {trace.flops:.6e}, counted "
        f"{flops:.6e} ({'equal' if trace.flops == flops else 'DIFFER'}); "
        f"peak traced {trace.peak / 2**30:.3f} GiB, measured with no "
        f"dispatch mode {plain_peak / 2**30:.3f} GiB (relative {rel:+.4f}, "
        f"limit {tol}); the counted step's "
        f"{counted_peak / 2**30:.3f} GiB [{smi}]")
    if trace.flops != flops:
        raise AssertionError(f"phase 14 {name}: traced FLOPs {trace.flops} "
                             f"!= measured {flops}")
    if not abs(rel) <= tol:
        raise AssertionError(f"phase 14 {name}: traced peak "
                             f"{trace.peak} against measured {plain_peak}")
    return row


def dryrun_path(dev, seed, step_ms=None, smi="", log=print):
    """Phase 14: (a) to (d) above.  ``step_ms`` is phase 13's measured
    step (its last), printed beside (c)'s bounds.  (d)'s children start
    first and run on the host's cores while (a) to (c) run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import dryrun, serve, train
    from repro_torch.models import Model, decode_step, prefill
    from repro_torch.optim import adamw_init
    from repro_torch.roofline import HW, analyze_trace
    t_phase = time.perf_counter()
    host = _host_dryruns()
    out_dir, children = host
    out = {}
    try:
        cfg = get_config(TRAIN_ARCH)
        # (a) Phase 13's step: 8 x 4,096 tokens in 4 micro-batches.
        tshape = ShapeConfig("card_train", TRAIN_SEQ, TRAIN_BATCH, "train")
        t0 = time.perf_counter()
        tr_a, _ = dryrun.trace_cell(TRAIN_ARCH, tshape, None, dev,
                                    n_micro=TRAIN_MICRO)
        trace_a_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        model = Model(cfg, device=dev, seed=seed)
        opt = adamw_init(model)
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH, seed=seed)
        batch = {k: v.to(torch.int32) for k, v in
                 train.to_device(pipe.next_batch(), dev).items()}
        step = train.make_train_step(cfg, n_micro=TRAIN_MICRO)
        # Step 0 (lr 0) with no dispatch mode, then step 1 counted.
        _, _, plain = _measured_step(dev, lambda: step(model, opt, batch),
                                     count=False)
        t0 = time.perf_counter()
        _, flops, peak = _measured_step(dev, lambda: step(model, opt, batch))
        out["train"] = _held("(a) phase 13's step", tr_a, plain - base,
                             flops, peak - base, log, smi, dryrun.PEAK_TOL)
        out["train"].update(trace_s=trace_a_s,
                            counted_step_s=time.perf_counter() - t0)
        del model, opt, batch, step
        gc.collect()
        torch.cuda.empty_cache()

        # (b) Phase 12's request A: prefill 4 x 512 into a 552-deep cache,
        # then one decode step.
        b, p, g = SERVE_REQUESTS["A"]
        s_max = p + g + 8
        pshape = ShapeConfig("card_prefill", p, b, "prefill")
        dshape = ShapeConfig("card_decode", s_max, b, "decode")
        tr_p, _ = dryrun.trace_cell(SERVE_ARCH, pshape, None, dev,
                                    s_max=s_max)
        tr_d, _ = dryrun.trace_cell(SERVE_ARCH, dshape, None, dev)
        base = torch.cuda.memory_allocated(dev)
        model = Model(get_config(SERVE_ARCH), device=dev, seed=seed)
        scfg = get_config(SERVE_ARCH)
        req = serve.make_batch(scfg, b, p, seed + 1, dev)
        (logits, cache), _, plain = _measured_step(
            dev, lambda: prefill(scfg, model, req, s_max=s_max),
            count=False)
        del logits, cache
        (logits, cache), flops, peak = _measured_step(
            dev, lambda: prefill(scfg, model, req, s_max=s_max))
        out["prefill"] = _held("(b) request A's prefill", tr_p,
                               plain - base, flops, peak - base, log, smi,
                               dryrun.PEAK_TOL)
        tok = torch.argmax(logits, -1).to(torch.int32)
        del logits, req
        gc.collect()
        _, _, plain = _measured_step(
            dev, lambda: decode_step(scfg, model, cache, tok, p),
            count=False)
        _, flops, peak = _measured_step(
            dev, lambda: decode_step(scfg, model, cache, tok, p))
        out["decode"] = _held("(b) request A's decode step", tr_d,
                              plain - base, flops, peak - base, log, smi,
                              dryrun.PEAK_TOL)
        del model, cache, tok
        gc.collect()
        torch.cuda.empty_cache()

        # (c) The roofline terms of (a)'s trace against the hand bound.
        rep = analyze_trace(tr_a, arch=TRAIN_ARCH, shape_cfg=tshape,
                            cfg=cfg, mesh_name="card", chips=1,
                            hw=HW.for_mesh({}))
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            hand_flops, hand_ms, hand_by = training_bound(
                cfg, Model(cfg, device=dev, seed=seed), TRAIN_BATCH,
                TRAIN_SEQ)
        # The trace's bytes term is an operand volume (every op's operands
        # and results at their logical sizes), not HBM traffic: it is
        # printed, and left out of the bound.
        out["bounds"] = dict(
            t_compute_ms=rep.t_compute * 1e3,
            t_collective_ms=rep.t_collective * 1e3,
            operand_bytes=rep.bytes_per_device,
            operand_volume_ms=rep.t_memory * 1e3,
            trace_flops=rep.flops_per_device, hand_flops=hand_flops,
            hand_bound_ms=hand_ms, hand_bound_by=hand_by,
            measured_step_ms=step_ms, model_flops=rep.model_flops)
        bound_ms = max(rep.t_compute, rep.t_collective) * 1e3
        # Non-reentrant checkpointing stops each layer's recompute once the
        # tensors its backward needs exist: the last product (the MLP's
        # down projection), which the hand bound counts, is not redone.
        skipped = (2.0 * cfg.d_model * cfg.d_ff * cfg.n_layers * TRAIN_BATCH
                   * TRAIN_SEQ)
        out["bounds"]["remat_skipped_flops"] = skipped
        why = ("they agree" if abs(bound_ms - hand_ms) <= 0.05 * hand_ms
               else "they differ")
        why += (f": the FLOPs differ by "
                f"{rep.flops_per_device / hand_flops - 1:+.4f}, "
                f"{(rep.flops_per_device + skipped) / hand_flops - 1:+.2e} "
                f"with the {skipped:.4e} FLOP of down projections that "
                f"remat's early stop does not recompute")
        log(f"dry run (card) (c) phase 13's step: t_compute "
            f"{rep.t_compute * 1e3:.1f} ms, t_collective "
            f"{rep.t_collective * 1e3:.1f} ms: bound {bound_ms:.1f} ms "
            f"against the hand bound {hand_ms:.1f} ms ({hand_by}) and the "
            f"measured step "
            f"{'-' if step_ms is None else f'{step_ms:.1f}'} ms: {why}; "
            f"the operand volume {rep.bytes_per_device:.4e} B (every op's "
            f"operands and results at their logical sizes, not HBM "
            f"traffic) over HBM's rate is {rep.t_memory * 1e3:.1f} ms, no "
            f"bound [{smi}]")

        # (d) The single-pod cells on the host.
        out["host_cells"] = {}
        for i, (name, proc, t_start) in enumerate(children):
            try:
                proc.wait(timeout=max(1.0, DRYRUN_CHILD_TIMEOUT - (
                    time.perf_counter() - t_start)))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"phase 14 (d) {name}: over "
                                     f"{DRYRUN_CHILD_TIMEOUT} s")
            text = (Path(out_dir) / f"child{i}.log").read_text()
            waited = time.perf_counter() - t_start
            arch, shape, mesh = name.split(" x ")
            fname = (f"{arch}__{shape}.json" if arch != "lsmgraph-service"
                     else "lsmgraph-service__pagerank.json")
            with open(Path(out_dir) / mesh / fname) as f:
                rec = json.load(f)
            out["host_cells"][name] = dict(
                status=rec["status"], wall_s=rec.get("wall_s"),
                process_done_s=waited,
                **{k: rec[k] for k in ("bottleneck", "t_compute_s",
                                       "t_memory_s", "t_collective_s",
                                       "peak_memory_per_device",
                                       "collective_bytes_per_device",
                                       "replicated_at") if k in rec})
            log(f"dry run (d) {name} on the host: {rec['status']} in "
                f"{rec.get('wall_s')} s (its process done by {waited:.1f} "
                f"s): {json.dumps(out['host_cells'][name])} [{smi}]")
            if proc.returncode != 0 or rec["status"] != "ok":
                raise AssertionError(f"phase 14 (d) {name}: "
                                     f"{rec.get('error')}\n{text[-2000:]}")
    finally:
        _stop_host_dryruns(host)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _stop_host_dryruns(host) -> None:
    """Kill whichever of ``_host_dryruns``' children still runs and remove
    their directory."""
    import shutil
    out_dir, children = host
    for _, proc, _ in children:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(out_dir, ignore_errors=True)


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
    ap.add_argument("--train-replay", metavar="DIR",
                    help="run phase 13 (d)'s child in DIR and stop")
    ap.add_argument("--device", default="cuda",
                    help="the device of --train-replay")
    args = ap.parse_args(argv)
    if args.train_replay:
        print(json.dumps(train_replay(args.device, args.seed,
                                      args.train_replay)))
        return 0

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
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bench = benchmarks_path(dev, smi)
    launches["benchmarks"] = bench["launches"]
    print(f"main path (benchmarks) launches: {bench['launches']}")
    print(f"main path (benchmarks): {json.dumps(bench)}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dst11 = distributed_path(dev, oracle, stream, args.seed,
                             store_config().batch_cap, smi)
    launches["distributed"] = dst11.pop("launches")
    print(f"main path (distributed) launches, summed over the "
          f"{DIST_RANKS} ranks: {launches['distributed']}")
    print(f"main path (distributed): {json.dumps(dst11)}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    ops.reset_launches()
    t0 = time.perf_counter()
    srv = serving_path(dev, args.seed, smi)
    launches["serving"] = ops.launch_counts()
    print(f"main path (serving) launches: {launches['serving']}")
    others = {k: n for k, n in launches["serving"].items()
              if n and k != "flash_attention"}
    if others or launches["serving"]["flash_attention"] != 1:
        raise AssertionError(f"the serving phase launched {others or 'no'} "
                             f"graph-store kernels and flash_attention "
                             f"{launches['serving']['flash_attention']} "
                             f"times (want none and once)")
    print(f"main path (serving): {json.dumps(srv)}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    del srv
    gc.collect()
    torch.cuda.empty_cache()

    ops.reset_launches()
    t0 = time.perf_counter()
    trn = training_path(dev, args.seed, smi)
    launches["training"] = ops.launch_counts()
    print(f"main path (training) launches: {launches['training']}")
    if any(launches["training"].values()):
        raise AssertionError(f"the training phase launched "
                             f"{launches['training']} (want none)")
    print(f"main path (training): {json.dumps(trn)}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    step_ms = trn["steps"][-1]["ms"]
    del trn
    gc.collect()
    torch.cuda.empty_cache()

    ops.reset_launches()
    t0 = time.perf_counter()
    dry = dryrun_path(dev, args.seed, step_ms, smi)
    launches["dryrun"] = ops.launch_counts()
    if any(launches["dryrun"].values()):
        raise AssertionError(f"the dry-run phase launched "
                             f"{launches['dryrun']} (want none)")
    print(f"main path (dry run): {json.dumps(dry)}; phase "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
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
               | ({"launches_distributed":
                   launches["distributed"]["gather_segsum"]}
                  if r["name"] == "gather_segsum" else {})
               | ({"launches_serving":
                   launches["serving"]["flash_attention"]}
                  if r["name"] == "flash_attention" else {})
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
