"""Step timing / heartbeat monitor (the port of ``repro.runtime.monitor``).

Once CUDA is in use in the process, ``stop()`` first waits for the card
(``torch.cuda.synchronize``), so a step's time is the device's and not the
time to enqueue it."""
from __future__ import annotations

import time
from typing import Dict, List

import torch


class StepMonitor:
    def __init__(self):
        self.times: List[float] = []
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        return {
            "mean_s": sum(ts) / len(ts),
            "p50_s": ts[len(ts) // 2],
            "p99_s": ts[min(len(ts) - 1, int(len(ts) * 0.99))],
            "n": len(ts),
        }
