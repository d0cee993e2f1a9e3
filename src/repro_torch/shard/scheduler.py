"""Amplification-driven compaction scheduler (the "acting" half of the
amplification instrumentation).

The port of ``repro.shard.scheduler``: the same ranking, idle detection,
backoff and ``compaction_sched_*`` families, over the port's sharded store
and its ``AmplificationLedger``.  A tick's compaction runs on the
scheduler's thread and launches on the device's default stream, like every
other thread of the port.

``ShardedGraphStore.compact_all()`` drains every shard at once — fine as a
maintenance barrier, terrible as a steady-state policy: it stalls ingest on
EVERY shard exactly when the busiest one needs the cycles.  This scheduler
closes the loop the observability PRs opened: it reads the per-shard
ranking signals that already exist (L0 depth from the published
``StoreState``, read amplification from ``AmplificationLedger.ratios()``,
writer-visible latency from the ``shard_ack_seconds`` histograms) and
compacts ONE worst-offender shard per tick, only while that shard is idle,
with a global backoff driven by ack latency so scheduling can never
inflate writer p99.

Policy (also summarized in ``shard/__init__``'s package doc):

* **Ranking**: ``score(s) = l0_weight * L0_depth(s) +
  read_weight * runs_per_query(s)`` — depth is the write-side debt
  (every L0 run is one more sorted source each read must consult), and
  runs-per-query is the read side actually paying for it.  Shards below
  ``min_l0`` L0 runs are never scheduled (nothing worth merging).
* **Idle detection**: a shard whose ``shard_ack_seconds`` count advanced
  since the previous tick is HOT — a writer is actively committing there —
  and is skipped this tick.  Fenced shards are skipped outright.
* **Backoff**: per tick, the windowed mean ack latency (delta sum / delta
  count over ALL shards) is compared with the previous window's.  If the
  scheduler compacted last tick and the mean grew by more than
  ``ack_slowdown``x, compaction pauses and the tick interval multiplies by
  ``backoff`` (capped at ``max_interval``); calm windows decay the
  interval back toward ``interval``.  The budget is therefore expressed in
  the same unit the SLO is: writer-observed ack seconds.

``step()`` is synchronous and deterministic (no clock, no randomness) so
tests and benchmarks can drive the policy directly; ``start()`` wraps it
in a daemon thread for the serving path.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .. import obs
from ..obs.amplification import AmplificationLedger


class CompactionScheduler:
    """Background L0->L1 compaction for one ``ShardedGraphStore``."""

    def __init__(self, store, *, interval: float = 0.05,
                 l0_weight: float = 1.0, read_weight: float = 4.0,
                 min_l0: int = 2, ack_slowdown: float = 1.5,
                 backoff: float = 2.0, max_interval: float = 1.0):
        self.store = store
        self.base_interval = float(interval)
        self.interval = float(interval)
        self.l0_weight = float(l0_weight)
        self.read_weight = float(read_weight)
        self.min_l0 = int(min_l0)
        self.ack_slowdown = float(ack_slowdown)
        self.backoff = float(backoff)
        self.max_interval = float(max_interval)
        n = store.n_shards
        self._ack_hists = [obs.histogram("shard_ack_seconds", shard=str(s))
                           for s in range(n)]
        self._last_counts: List[int] = [h.count for h in self._ack_hists]
        self._last_sum: float = sum(h.sum for h in self._ack_hists)
        self._last_mean: Optional[float] = None
        self._compacted_last = False
        self._obs_decision = {
            d: obs.counter("compaction_sched_decision_total", decision=d)
            for d in ("compact", "skip_hot", "skip_backoff", "idle")}
        self._obs_compactions = [
            obs.counter("compaction_sched_compactions_total", shard=str(s))
            for s in range(n)]
        self._obs_interval = obs.gauge("compaction_sched_interval_seconds")
        self._obs_interval.set(self.interval)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- signals
    def _ack_window(self):
        """(hot shard set, windowed mean ack seconds | None) since the
        previous tick, advancing the per-shard count cursor."""
        counts = [h.count for h in self._ack_hists]
        sums = [h.sum for h in self._ack_hists]
        hot = {s for s, c in enumerate(counts) if c > self._last_counts[s]}
        dn = sum(counts) - sum(self._last_counts)
        ds = sum(sums) - self._last_sum
        self._last_sum = sum(sums)
        self._last_counts = counts
        return hot, (ds / dn if dn > 0 else None)

    def shard_scores(self) -> Dict[int, float]:
        """The ranking formula over every serving shard (public: rendered
        by benchmarks and asserted by the policy unit tests)."""
        fenced = self.store.fenced()
        scores: Dict[int, float] = {}
        for s, g in enumerate(self.store.shards):
            if s in fenced:
                continue
            depth = len(g._state.levels[0])
            if depth < self.min_l0:
                continue
            r = AmplificationLedger(g).ratios()
            rpq = r.get("runs_per_query") or 0.0
            scores[s] = self.l0_weight * depth + self.read_weight * rpq
        return scores

    # ---------------------------------------------------------------- step
    def step(self) -> dict:
        """One scheduling decision.  Returns {"decision", "shard",
        "interval"} for observability/tests; also feeds the
        ``compaction_sched_*`` metric families."""
        hot, mean = self._ack_window()
        # Backoff before anything else: if last tick's compaction coincided
        # with a windowed ack-latency jump, yield the cycles back to the
        # writers and widen the tick.
        if (self._compacted_last and mean is not None
                and self._last_mean is not None
                and mean > self._last_mean * self.ack_slowdown):
            self.interval = min(self.interval * self.backoff,
                                self.max_interval)
            decision, shard = "skip_backoff", None
        else:
            self.interval = max(self.base_interval,
                                self.interval / self.backoff)
            scores = self.shard_scores()
            eligible = {s: sc for s, sc in scores.items() if s not in hot}
            if eligible:
                shard = max(eligible, key=lambda s: (eligible[s], -s))
                self.store.shards[shard].compact_l0()
                self._obs_compactions[shard].inc()
                decision = "compact"
            elif scores:
                decision, shard = "skip_hot", None
            else:
                decision, shard = "idle", None
        if mean is not None:
            self._last_mean = mean
        self._compacted_last = decision == "compact"
        self._obs_decision[decision].inc()
        self._obs_interval.set(self.interval)
        return {"decision": decision, "shard": shard,
                "interval": self.interval}

    # -------------------------------------------------------------- thread
    def start(self) -> "CompactionScheduler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="compaction-sched", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.step()
            except Exception:
                # A mid-compaction shard fence/close must not kill the
                # scheduler thread; the next tick re-reads health state.
                pass

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30.0)
            self._thread = None


__all__ = ["CompactionScheduler"]
