"""Concurrent LSMGraph (paper §4.3 'Concurrent Read and Write', Fig 18).

Wraps the store with:
  * an ingest queue drained by a writer thread (vertex-grained write safety
    is inherent: batch inserts are functional array updates);
  * a background compactor thread — flush and compaction happen off the
    writer's critical path, exactly the paper's asynchronous compaction;
  * reader API: `snapshot()` pins a consistent (version, index, runs, τ) view
    at any time, including mid-compaction (immutability replaces the paper's
    vertex-grained read-write locks).

The port of ``repro.core.concurrent``.  The wrapper adds no read-side
synchronization: ``snapshot()`` is one atomic reference load of the store's
published state plus a version pin — it never contends with the writer or
compactor thread, which publish fresh states instead of mutating the one a
reader holds.  Both threads launch on the device's default stream (a new
thread's current stream), as every reader does, so work they publish is
ordered before any later read's kernels.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Optional

import numpy as np

from .. import obs
from .store import LSMGraph, Snapshot
from .types import StoreConfig
from . import memgraph as mg_mod


class ConcurrentLSMGraph:
    def __init__(self, cfg: Optional[StoreConfig] = None,
                 drain_batch: int = 8, store: Optional[LSMGraph] = None,
                 device=None):
        """Wrap a store with ingest/compactor threads.  Pass ``store`` to
        wrap a pre-built (e.g. durable, via ``repro_torch.storage.
        open_store``) instance; otherwise a fresh in-memory store is built
        from ``cfg`` on ``device`` (None: the current CUDA card)."""
        if store is None:
            assert cfg is not None, "need cfg or a pre-built store"
            store = LSMGraph(cfg, device=device)
        self.store = store
        self.store.on_flush_needed = lambda: self._compact_request.set()
        self._q: "queue.Queue" = queue.Queue(maxsize=256)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        # Structured capture of the most recent background failure per
        # thread: {"work", "error", "traceback"} — surfaced by _check()'s
        # raise chain, close()'s leak report, and the registry counter
        # below (no bare print_exc to a lost stderr).
        self.last_errors: dict = {}
        self._compact_request = threading.Event()
        # Current work item per background thread, for close()'s leak
        # report: when a join times out, naming what the thread is stuck on
        # ("flush_memgraph", "insert batch of 4096") beats a silent leak.
        self._busy = {"writer": None, "compactor": None}
        self._writer = threading.Thread(target=self._writer_loop, daemon=True,
                                        name="lsmg-writer")
        self._compactor = threading.Thread(
            target=self._compactor_loop, daemon=True, name="lsmg-compactor")
        self._writer.start()
        self._compactor.start()

    # ------------------------------------------------------------------- API
    def insert_edges(self, src, dst, prop=None) -> None:
        self._check()
        if self._stop.is_set():
            raise RuntimeError("store is closed")
        self._q.put(("insert", np.asarray(src), np.asarray(dst),
                     None if prop is None else np.asarray(prop)))

    def delete_edges(self, src, dst) -> None:
        self._check()
        if self._stop.is_set():
            raise RuntimeError("store is closed")
        self._q.put(("delete", np.asarray(src), np.asarray(dst), None))

    def snapshot(self) -> Snapshot:
        self._check()
        return self.store.snapshot()

    def flush(self) -> None:
        """Block until all queued updates are applied (not compacted)."""
        while not self._q.unfinished_tasks == 0:
            self._check()
            time.sleep(0.01)
        self._check()

    # Join budgets, overridable for tests (a wedged-thread test should not
    # take 70 s to prove the leak is reported).
    _WRITER_JOIN_TIMEOUT = 10.0
    _COMPACTOR_JOIN_TIMEOUT = 60.0

    def close(self) -> None:
        self.flush()
        self._stop.set()
        self._writer.join(timeout=self._WRITER_JOIN_TIMEOUT)
        self._compactor.join(timeout=self._COMPACTOR_JOIN_TIMEOUT)
        # join(timeout=) returns None either way — check is_alive() or a
        # wedged thread silently leaks past close() while holding the store
        # lock / WAL handles its successor will need.
        leaked = [(name, thread, self._busy.get(name))
                  for name, thread in (("writer", self._writer),
                                       ("compactor", self._compactor))
                  if thread.is_alive()]
        if leaked:
            detail = "; ".join(
                f"{name} thread still alive after join timeout"
                + (f" (stuck on: {work})" if work else "")
                + (f" (last error: {self.last_errors[name]['error']})"
                   if name in self.last_errors else "")
                for name, _t, work in leaked)
            raise RuntimeError(f"close() leaked background threads: {detail}")
        self.store.close()  # durable: fsync WAL tail + release handles
        self._check()

    # --------------------------------------------------------------- threads
    def _check(self) -> None:
        if self._error is not None:
            raise RuntimeError("background thread failed") from self._error

    def _note_error(self, thread_name: str, e: BaseException) -> None:
        """Record a background failure: structured last-error capture (for
        ``_check``/``close``) plus a registry counter — never a bare
        ``print_exc`` that vanishes with a redirected stderr."""
        self.last_errors[thread_name] = {
            "work": self._busy.get(thread_name),
            "error": repr(e),
            "traceback": traceback.format_exc(),
        }
        obs.counter("store_background_errors_total",
                    thread=thread_name).inc()
        self._error = e
        self._stop.set()

    def _writer_loop(self) -> None:
        store = self.store
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                op, src, dst, prop = item
                self._busy["writer"] = f"{op} batch of {len(src)}"
                # Apply without triggering inline flush: the compactor owns
                # flush+compaction so the writer returns to ingest quickly.
                store._apply_no_flush(src, dst, prop, delete=(op == "delete"))
                if mg_mod.memgraph_should_flush(store.mem, store.cfg):
                    self._compact_request.set()
            except BaseException as e:  # surface to callers
                self._note_error("writer", e)
            finally:
                self._busy["writer"] = None
                self._q.task_done()

    def _compactor_loop(self) -> None:
        store = self.store
        while not self._stop.is_set():
            self._compact_request.wait(timeout=0.02)
            self._compact_request.clear()
            try:
                # Poll regardless of the signal: the writer may be blocked
                # mid-item on a hard-full cache waiting for exactly this.
                if mg_mod.memgraph_should_flush(store.mem, store.cfg):
                    self._busy["compactor"] = "flush_memgraph"
                    store.flush_memgraph()  # includes L0 compaction + cascade
                # Durable stores: WAL group-commit fsync runs on the WAL's
                # own background thread (wal.py), off the writer's critical
                # path; close() below issues the final barrier.
            except BaseException as e:
                self._note_error("compactor", e)
            finally:
                self._busy["compactor"] = None
