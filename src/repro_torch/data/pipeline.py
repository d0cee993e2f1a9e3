"""Deterministic, sharded, resumable token pipeline.

Production requirements it satisfies (tests/test_data.py):
  * determinism — batch t is a pure function of (seed, t), independent of
    how many times the pipeline restarted;
  * sharding — host h of H draws disjoint slices of the global batch, so
    the global batch is identical for any host count that divides it
    (elastic rescaling keeps the data order);
  * resumability — state is one integer (next step) + seed: it rides in the
    checkpoint manifest and restores exactly.

The "corpus" is a seeded synthetic stream (documents of zipf-ish tokens with
EOS framing) — the substrate the paper-hosting framework trains on; swapping
in a real tokenized corpus only replaces `_doc_tokens`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PipelineState:
    seed: int
    next_step: int

    def to_json(self) -> Dict:
        return {"seed": self.seed, "next_step": self.next_step}

    @staticmethod
    def from_json(d: Dict) -> "PipelineState":
        return PipelineState(seed=int(d["seed"]),
                             next_step=int(d["next_step"]))


class TokenPipeline:
    def __init__(self, *, vocab: int, seq_len: int, global_batch: int,
                 host_id: int = 0, n_hosts: int = 1, seed: int = 0,
                 state: Optional[PipelineState] = None):
        assert global_batch % n_hosts == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.state = state or PipelineState(seed=seed, next_step=0)

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def _row(self, step: int, row: int) -> np.ndarray:
        """Global row `row` of batch `step` — pure function of (seed, step,
        row).  Zipf-ish unigram docs with EOS=0 framing."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.state.seed, step, row]))
        out = np.empty(self.seq_len + 1, np.int32)
        i = 0
        while i < len(out):
            doc_len = int(rng.integers(16, 512))
            r = rng.random(doc_len)
            toks = (self.vocab * (r ** 3)).astype(np.int32) % self.vocab
            toks = np.maximum(toks, 1)
            n = min(doc_len, len(out) - i)
            out[i:i + n] = toks[:n]
            i += n
            if i < len(out):
                out[i] = 0  # EOS
                i += 1
        return out

    def next_batch(self) -> Dict[str, np.ndarray]:
        step = self.state.next_step
        rows = range(self.host_id * self.local_batch,
                     (self.host_id + 1) * self.local_batch)
        data = np.stack([self._row(step, r) for r in rows])
        self.state.next_step += 1
        return {"tokens": data[:, :-1], "targets": data[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
