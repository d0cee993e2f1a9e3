"""Fault-tolerant training loop: checkpoint/restart + straggler mitigation
(the port of ``repro.runtime.fault``: the same control flow, straggler rule
and metrics).

On a real cluster, failures arrive as device errors / heartbeat loss; here
a failure injector raises SimulatedFailure at chosen steps so tests exercise
the exact recovery path:

    run() -> step -> [failure] -> restore(latest ckpt) -> replay data state
          -> continue; bitwise-equal to an uninterrupted run (test asserts).

Straggler mitigation: per-step wall-time EWMA; a step slower than
`straggler_factor` x the EWMA increments a counter and triggers `on_straggler`
(production: re-shard / swap out the slow host; here: recorded + surfaced).
Elastic scaling: a restored state can be placed on another device or mesh
by checkpoint.elastic.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import PipelineState, TokenPipeline


class SimulatedFailure(RuntimeError):
    pass


class FailureInjector:
    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class FaultTolerantLoop:
    def __init__(self, *, step_fn: Callable, init_state: Any,
                 pipeline: TokenPipeline, ckpt: CheckpointManager,
                 ckpt_every: int = 10, injector:
                 Optional[FailureInjector] = None,
                 straggler_factor: float = 3.0,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 max_restarts: int = 8):
        self.step_fn = step_fn
        self.state = init_state
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.injector = injector or FailureInjector()
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler
        self.max_restarts = max_restarts
        self.restarts = 0
        self.stragglers = 0
        self.metrics: Dict[int, float] = {}

    def _restore(self) -> int:
        latest = self.ckpt.latest_step()
        if latest is None:
            self.pipeline.state = PipelineState(
                seed=self.pipeline.state.seed, next_step=0)
            return 0
        self.state, extra = self.ckpt.restore(self.state, step=latest)
        self.pipeline.state = PipelineState.from_json(extra["pipeline"])
        return latest

    def run(self, n_steps: int) -> Any:
        step = self._restore() if self.ckpt.latest_step() is not None else 0
        ewma = None
        while step < n_steps:
            try:
                batch = self.pipeline.next_batch()
                t0 = time.perf_counter()
                self.injector.maybe_fail(step)
                self.state, loss = self.step_fn(self.state, batch)
                dt = time.perf_counter() - t0
                self.metrics[step] = float(loss)
                # --- straggler detection -------------------------------
                if ewma is not None and dt > self.straggler_factor * ewma:
                    self.stragglers += 1
                    if self.on_straggler:
                        self.on_straggler(step, dt)
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(
                        step, self.state,
                        extra={"pipeline": self.pipeline.state.to_json()})
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                step = self._restore()
        self.ckpt.wait()
        return self.state
