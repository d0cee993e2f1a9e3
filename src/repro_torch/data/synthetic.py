"""Synthetic LM batches for smoke tests and benchmarks (numpy only): the
port's copy of ``repro.data.synthetic``."""
from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_lm_batch(*, vocab: int, seq_len: int, batch: int,
                       seed: int = 0, d_model: int = 0,
                       frontend: str = "none",
                       frontend_len: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {
        "tokens": rng.integers(1, vocab, (batch, seq_len)).astype(np.int32)}
    out["targets"] = np.roll(out["tokens"], -1, axis=1)
    if frontend != "none":
        out["frontend"] = rng.normal(
            0, 1, (batch, frontend_len, d_model)).astype(np.float32)
    return out
