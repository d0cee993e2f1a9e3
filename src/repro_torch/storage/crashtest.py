"""Subprocess child for SIGKILL crash-recovery tests.

Opens a durable store and ingests deterministic batches forever, printing
``acked <i>`` after each batch is applied AND the WAL is fsync'd.  The
parent test SIGKILLs this process at an arbitrary moment, reopens the
directory, and asserts that every acknowledged batch survived recovery
(unacked suffix batches may or may not — both are legal).

    python -m repro_torch.storage.crashtest --dir DIR [--batch 64] [--seed 0]
        [--device cpu]

Batch ``i`` is reproducible from ``(seed, i)`` via :func:`batch_edges`.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def batch_edges(seed: int, i: int, batch: int, vmax: int):
    """Deterministic edge batch i (shared by child and verifying parent)."""
    rng = np.random.default_rng(seed * 1_000_003 + i)
    src = rng.integers(0, vmax, batch).astype(np.int32)
    dst = rng.integers(0, vmax, batch).astype(np.int32)
    return src, dst


def small_cfg(vmax: int = 1 << 12):
    from ..core import StoreConfig
    return StoreConfig(vmax=vmax, mem_edges=1 << 10, seg_size=4,
                       n_segments=1 << 10, hash_slots=1 << 12,
                       ovf_cap=1 << 12, batch_cap=256, l0_run_limit=2,
                       seg_target_edges=1 << 10)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vmax", type=int, default=1 << 12)
    ap.add_argument("--max-batches", type=int, default=10_000)
    ap.add_argument("--device", default=None,
                    help="the store's device (default: the CUDA card)")
    args = ap.parse_args()

    from .engine import open_store
    g = open_store(args.dir, small_cfg(args.vmax), device=args.device,
                   wal_sync="batch")
    for i in range(args.max_batches):
        src, dst = batch_edges(args.seed, i, args.batch, args.vmax)
        g.insert_edges(src, dst)
        g.sync()  # durability barrier before acking
        print(f"acked {i}", flush=True)


if __name__ == "__main__":
    main()
