"""Randomized fault-schedule harness: inject disk faults, check invariants.

Each schedule (one seed) drives a fresh durable store through a random
op trace — insert/delete batches, acks, flushes, evictions, reads — arms a
random ``faultfs.FaultPlan`` partway through (failed fsync, read EIO, torn
WAL write, or a segment bit-flip), then clears the plan, reopens the
directory, and checks the failure-model invariants:

  I1  (prefix consistency)  the reopened edge set equals the fold of some
      PREFIX of the fully-applied batches — at least everything acked —
      modulo edges whose source falls in an explicitly-reported degraded
      vertex range (quarantined segment that could not be rebuilt).
  I2  (acked writes survive) the matching prefix is never shorter than the
      last acked batch: ``ack()`` returning is a durability promise.
  I3  (typed failures only)  reads raise nothing but ``StorageError``
      subclasses; writes raise only ``StorageError``/``OSError`` (the first
      failed fsync surfaces as the raw errno before the fail-stop latch
      types everything after it).  Any other exception — or an interpreter
      crash — fails the schedule.

Violations raise ``ChaosViolation``.  Run standalone::

    PYTHONPATH=src python -m repro_torch.storage.chaostest --schedules 100 \
        [--device cpu]

Determinism: one ``random.Random(seed)`` drives batch content, fault
choice, and timing, so a failing seed replays exactly.
"""
from __future__ import annotations

import argparse
import random
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.types import StoreConfig
from . import faultfs
from .engine import open_store
from .errors import StorageError


class ChaosViolation(AssertionError):
    """A fault schedule broke a durability/consistency invariant."""


# One rule template per fault kind; ``skip`` randomizes WHICH matching call
# fires so the same kind probes different protocol points across seeds.
FAULT_KINDS = (
    "wal_fsync",        # fail an fsync of a WAL file        (fail-stop latch)
    "seg_fsync",        # fail an fsync of a segment file    (flush aborts)
    "manifest_fsync",   # fail the manifest publish fsync    (commit aborts)
    "wal_torn",         # torn os.write on a WAL append      (latch + replay drop)
    "read_eio",         # EIO on segment reads               (transient; retried)
    "bitflip",          # flip one bit in a segment body     (CRC -> quarantine)
)


def _make_plan(rng: random.Random, kind: str) -> faultfs.FaultPlan:
    plan = faultfs.FaultPlan()
    if kind == "wal_fsync":
        plan.add(faultfs.FaultRule(op="fsync", match="wal-",
                                   skip=rng.randrange(3)))
    elif kind == "seg_fsync":
        plan.add(faultfs.FaultRule(op="fsync", match=".csr",
                                   skip=rng.randrange(2)))
    elif kind == "manifest_fsync":
        plan.add(faultfs.FaultRule(op="fsync", match="MANIFEST",
                                   skip=rng.randrange(2)))
    elif kind == "wal_torn":
        plan.add(faultfs.FaultRule(op="write", match="wal-",
                                   skip=rng.randrange(3),
                                   tear_at=rng.randrange(0, 24)))
    elif kind == "read_eio":
        # count <= retry budget: the read path should absorb these; a
        # larger count degenerates to a typed TransientIOError (also legal).
        plan.add(faultfs.FaultRule(op="read", match=".csr",
                                   skip=rng.randrange(2),
                                   count=rng.randrange(1, 5)))
    elif kind == "bitflip":
        plan.add(faultfs.FaultRule(op="bitflip", match=".csr",
                                   skip=rng.randrange(2),
                                   offset=64 + rng.randrange(256)))
    else:  # pragma: no cover - guarded by FAULT_KINDS
        raise ValueError(kind)
    return plan


def _gen_batches(rng: random.Random, n: int, vmax: int) -> List[Tuple]:
    """Random insert/delete batches (directed edges, <= 64 per batch so a
    batch is a single WAL record / apply chunk — applies are atomic at
    batch granularity, which keeps invariant I1 a clean prefix check)."""
    batches = []
    live: List[Tuple[int, int]] = []
    for _ in range(n):
        if live and rng.random() < 0.25:
            k = rng.randrange(1, min(16, len(live)) + 1)
            picks = rng.sample(live, k)
            src = np.array([u for u, _ in picks], np.int64)
            dst = np.array([v for _, v in picks], np.int64)
            batches.append(("delete", src, dst))
        else:
            k = rng.randrange(8, 64)
            src = rng.choices(range(vmax), k=k)
            dst = rng.choices(range(vmax), k=k)
            live.extend(zip(src, dst))
            batches.append(("insert", np.array(src, np.int64),
                            np.array(dst, np.int64)))
    return batches


def _fold(batches: List[Tuple], upto: int) -> set:
    edges: set = set()
    for op, src, dst in batches[:upto]:
        for u, v in zip(src.tolist(), dst.tolist()):
            if op == "insert":
                edges.add((u, v))
            else:
                edges.discard((u, v))
    return edges


def _edge_set_healthy(snap, degraded) -> set:
    """``Snapshot.edge_set`` restricted to vertices OUTSIDE the degraded
    ranges (querying inside one raises the typed CorruptionError by
    design — the harness enumerates what the store still promises)."""
    vs = snap.vertices()
    keep = [v for v in vs.tolist()
            if not any(r.lo <= v <= r.hi for r in degraded)]
    out: set = set()
    if not keep:
        return out
    for v, nbrs in zip(keep, snap.neighbors_batch(np.array(keep, np.int64))):
        for d in np.asarray(nbrs).tolist():
            out.add((v, d))
    return out


def _strip_degraded(edges: set, degraded) -> set:
    """Drop edges whose SOURCE vertex falls in a reported degraded range —
    the explicitly-unavailable portion both sides of the comparison must
    ignore."""
    if not degraded:
        return edges
    return {(u, v) for (u, v) in edges
            if not any(r.lo <= u <= r.hi for r in degraded)}


def _try_read(g, rng: random.Random, vmax: int, stats: Dict[str, int]) -> None:
    """A read under fire must either answer or raise a TYPED StorageError —
    anything else is invariant I3 broken."""
    vs = np.array(rng.choices(range(vmax), k=rng.randrange(1, 32)), np.int64)
    try:
        with g.snapshot() as snap:
            snap.neighbors_batch(vs)
        stats["reads_ok"] += 1
    except StorageError:
        stats["reads_degraded"] += 1
    except Exception as e:  # noqa: BLE001 - the whole point of the harness
        raise ChaosViolation(
            f"read raised untyped {type(e).__name__}: {e}") from e


def run_schedule(seed: int, root: Optional[str] = None,
                 keep: bool = False, device=None) -> Dict[str, object]:
    """Run one fault schedule; returns stats, raises ChaosViolation on any
    invariant break.  ``root`` defaults to a fresh temp dir (removed unless
    ``keep``); ``device`` is the store's (None: the CUDA card)."""
    rng = random.Random(seed)
    tmp = root or tempfile.mkdtemp(prefix=f"chaos-{seed}-")
    stats: Dict[str, object] = {
        "seed": seed, "reads_ok": 0, "reads_degraded": 0,
        "write_failed_at": None, "acked": 0, "applied": 0,
    }
    vmax = 512
    cfg = StoreConfig(vmax=vmax, mem_edges=4096, l0_run_limit=64)
    kind = rng.choice(FAULT_KINDS)
    stats["fault"] = kind
    fault_at = rng.randrange(2, 8)
    batches = _gen_batches(rng, rng.randrange(8, 15), vmax)

    g = open_store(tmp, cfg, device=device, wal_sync="always")
    applied = 0      # batches fully applied (no exception)
    acked = 0        # batches whose ack() returned (durability promised)
    armed = False
    try:
        for i, (op, src, dst) in enumerate(batches):
            if i == fault_at:
                faultfs.install(_make_plan(rng, kind))
                armed = True
            try:
                if op == "insert":
                    seq = g.insert_edges(src, dst)
                else:
                    seq = g.delete_edges(src, dst)
                applied = i + 1
                g.ack(seq)
                acked = i + 1
            except (StorageError, OSError) as e:
                # Fail-stop: the write (or its ack) failed with a TYPED
                # error — stop writing, state is some prefix (I1 decides).
                stats["write_failed_at"] = i
                stats["write_error"] = f"{type(e).__name__}: {e}"
                break
            if armed and rng.random() < 0.5:
                _try_read(g, rng, vmax, stats)
            if rng.random() < 0.3:
                try:
                    g.flush_memgraph()
                except (StorageError, OSError) as e:
                    stats["write_failed_at"] = i
                    stats["write_error"] = f"{type(e).__name__}: {e}"
                    break
        else:
            # Full trace applied; exercise the disk-read path under fire:
            # flush, drop the page-cache arrays, and read everything back.
            try:
                g.flush_memgraph()
            except (StorageError, OSError) as e:
                stats["write_error"] = f"{type(e).__name__}: {e}"
            if g.durability is not None:
                g.durability.evict_all_segments()
            for _ in range(3):
                _try_read(g, rng, vmax, stats)
    except ChaosViolation:
        raise
    except Exception as e:  # noqa: BLE001
        raise ChaosViolation(
            f"op trace raised untyped {type(e).__name__}: {e}") from e
    finally:
        faultfs.clear()
        try:
            g.close()
        except (StorageError, OSError):
            pass  # fail-stop close on a latched WAL is expected
    stats["applied"] = applied
    stats["acked"] = acked

    # ---- reopen with faults cleared: recovery + invariants I1/I2.
    g2 = open_store(tmp, device=device)
    try:
        degraded = g2.degraded_ranges()
        stats["degraded"] = [tuple(r) for r in degraded]
        with g2.snapshot() as snap:
            got = _edge_set_healthy(snap, degraded)
        # The failing batch itself may or may not have reached the WAL
        # (e.g. the append landed, only the fsync failed), so the valid
        # prefix extends one past ``applied`` when a write failed.
        hi = applied if stats["write_failed_at"] is None else \
            min(len(batches), int(stats["write_failed_at"]) + 1)
        match_j = next(
            (j for j in range(max(acked, 0), hi + 1)
             if _strip_degraded(_fold(batches, j), degraded) == got), None)
        if match_j is None:
            raise ChaosViolation(
                f"seed {seed} ({kind}): reopened state matches NO prefix in "
                f"[{acked}, {hi}] of the op trace (acked={acked}, "
                f"applied={applied}, degraded={stats['degraded']})")
        stats["recovered_prefix"] = match_j
    finally:
        try:
            g2.close()
        except (StorageError, OSError):
            pass
        if root is None and not keep:
            shutil.rmtree(tmp, ignore_errors=True)
    return stats


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--schedules", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed; schedule i runs with seed+i")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the store's device (default: the CUDA card)")
    args = ap.parse_args(argv)
    t0 = time.time()
    by_kind: Dict[str, int] = {}
    for i in range(args.schedules):
        stats = run_schedule(args.seed + i, device=args.device)
        by_kind[stats["fault"]] = by_kind.get(stats["fault"], 0) + 1
        if args.verbose:
            print(f"  seed {args.seed + i}: {stats}")
    print(f"chaos: {args.schedules} schedules, 0 violations "
          f"in {time.time() - t0:.1f}s; faults={by_kind}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
