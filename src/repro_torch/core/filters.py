"""Per-run vertex-presence filters (Aster-style run skipping).

Every sealed CSR run carries a small bloom filter over its SOURCE-vertex
set, so the read path can drop (run, query) pairs — and skip cold
segment loads entirely — for vertices a run cannot contain.  L0 runs
have no per-vertex index entries (only first/min-fid gates), so an
absent vertex otherwise probes every L0 run: the paper's Fig 8 "invalid
random read" problem, which Aster attacks with exactly this kind of
per-level membership filter.

Shape and hashing are pinned so the filter is a *pure deterministic
function of the vkey set*:

  * ``mbits`` = the power of two >= max(FILTER_MIN_BITS,
    FILTER_BITS_PER_KEY * nv) — derived from nv alone;
  * ``FILTER_K`` probe positions per key via splitmix32-style double
    hashing: ``pos_i = (h1 + i * h2) mod mbits`` with h1/h2 both
    avalanche mixes of the vertex id (h2 forced odd).

Determinism is what makes the durability story work: a segment rebuilt
from its WAL generation regenerates a byte-identical filter section
(tests/test_filters.py pins this), and the device-side membership test
(``kernels.presence``) re-implements the same mix over ``uint32``
wraparound arithmetic, so host build and device query can never skew —
zero false negatives by construction, false positives bounded by the
bits-per-key budget (~0.24% at 16 bits/key, k=4).

The packed words live host-side (numpy, for scalar reads and segment
serialization) with a lazily-uploaded device copy (a torch tensor, for the
vectorized batched-read test), both immutable after construction.  The
builder is the JAX package's ``repro.core.filters`` verbatim, so the same
vkeys give byte-equal words in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

#: Probes per key (k).  4 probes at 16 bits/key ≈ 0.24% false positives.
FILTER_K = 4
#: Bit budget per distinct source vertex before power-of-two rounding.
FILTER_BITS_PER_KEY = 16
#: Floor so tiny runs still get a real filter (8 words).
FILTER_MIN_BITS = 256
#: Salt decorrelating h2 from h1 (the golden-ratio constant).
FILTER_SALT = 0x9E3779B9

_U32 = np.uint32


def _mix32(x: np.ndarray) -> np.ndarray:
    """splitmix32-style avalanche finalizer over uint32 (wraparound
    multiplies).  MUST stay formula-identical to ``kernels.presence._mix32``
    and ``csrc/presence.cu`` — host build and device query share the hash
    by contract."""
    x = x.astype(_U32, copy=True)
    x ^= x >> _U32(16)
    x *= _U32(0x7FEB352D)
    x ^= x >> _U32(15)
    x *= _U32(0x846CA68B)
    x ^= x >> _U32(16)
    return x


def _hash_pair(v: np.ndarray):
    """(h1, h2) double-hashing pair per vertex id; h2 forced odd so the
    probe stride is invertible mod the power-of-two table size."""
    v = np.asarray(v, np.int64).astype(_U32)
    h1 = _mix32(v)
    h2 = _mix32(v ^ _U32(FILTER_SALT)) | _U32(1)
    return h1, h2


def filter_mbits(nv: int) -> int:
    """Filter size in bits for a run with ``nv`` distinct sources: the
    power of two >= max(FILTER_MIN_BITS, FILTER_BITS_PER_KEY * nv).
    Deterministic in nv — part of the rebuild-exactness contract."""
    need = max(FILTER_MIN_BITS, FILTER_BITS_PER_KEY * max(nv, 1))
    return 1 << (need - 1).bit_length()


def build_words(vkeys: np.ndarray) -> np.ndarray:
    """Pack the presence bits for a run's valid vkeys prefix into a
    little-endian uint32 word array of ``filter_mbits(len(vkeys)) // 32``
    words."""
    vk = np.asarray(vkeys, np.int64).ravel()
    mbits = filter_mbits(len(vk))
    words = np.zeros(mbits // 32, _U32)
    if len(vk) == 0:
        return words
    h1, h2 = _hash_pair(vk)
    mask = _U32(mbits - 1)
    for i in range(FILTER_K):
        pos = (h1 + _U32(i) * h2) & mask
        np.bitwise_or.at(words, pos >> _U32(5),
                         _U32(1) << (pos & _U32(31)))
    return words


@dataclasses.dataclass(eq=False)
class PresenceFilter:
    """One run's immutable presence filter: packed bits + derived size.

    ``words`` is the host copy (scalar reads, segment serialization);
    ``device_words(device)`` uploads once and caches — the device copy
    outlives segment eviction, which is the whole point: a cold run can
    reject a query without touching disk.  The device copy holds the same
    bits as int32 (torch has no arithmetic on uint32): the presence kernel
    reinterprets them as uint32."""

    words: np.ndarray          # uint32[mbits // 32], little-endian bits
    mbits: int                 # power of two
    _device: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False)

    @property
    def nbytes(self) -> int:
        return self.words.nbytes

    def device_words(self, device) -> torch.Tensor:
        """int32[mbits // 32] bit-copy of ``words`` on ``device``."""
        dev = self._device
        if dev is None or dev.device != torch.device(device):
            dev = torch.from_numpy(self.words.view(np.int32).copy()).to(device)
            self._device = dev
        return dev

    def might_contain(self, vs) -> np.ndarray:
        """Vectorized host-side membership test: bool per query vertex.
        False is definitive (zero false negatives); True means "probe"."""
        vs = np.atleast_1d(np.asarray(vs, np.int64))
        h1, h2 = _hash_pair(vs)
        mask = _U32(self.mbits - 1)
        hit = np.ones(len(vs), bool)
        for i in range(FILTER_K):
            pos = (h1 + _U32(i) * h2) & mask
            bit = (self.words[pos >> _U32(5)]
                   >> (pos & _U32(31))) & _U32(1)
            hit &= bit != 0
        return hit


def from_vkeys(vkeys) -> PresenceFilter:
    """Build a run's filter from its valid vkeys prefix (flush,
    compaction, resegment, and WAL rebuild all funnel through here, so
    every materialization of the same vkey set yields identical words)."""
    vk = np.asarray(vkeys, np.int64).ravel()
    return PresenceFilter(words=build_words(vk), mbits=filter_mbits(len(vk)))


def from_words(words: np.ndarray, mbits: int) -> PresenceFilter:
    """Rehydrate a filter from a segment file's filter section."""
    words = np.asarray(words, _U32)
    if mbits != words.shape[0] * 32 or mbits & (mbits - 1):
        raise ValueError(
            f"presence filter shape mismatch: mbits={mbits} "
            f"words={words.shape[0]}")
    return PresenceFilter(words=words, mbits=mbits)
