"""RocksDB-style LSM key-value baseline.

Each edge is one record keyed (src, dst); runs are globally key-sorted with
leveled compaction, but the store is graph-oblivious: neighbor reads binary-
search EVERY run (memtable + all levels), Bloom-filter style membership
pre-checks included, and each probe charges a whole 4 KB block (the paper's
read-amplification argument, §2.2).  No multi-level index.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .common import BLOCK_BYTES, IO, REC_BYTES, dedup_last, to_csr


class _Run:
    def __init__(self, src, dst, ts, marker, prop):
        order = np.lexsort((ts, dst, src))
        self.src = src[order]
        self.dst = dst[order]
        self.ts = ts[order]
        self.marker = marker[order]
        self.prop = prop[order]
        # Per-run 'Bloom filter': hashed src membership bitset (1 byte/edge
        # budget, false positives possible — like RocksDB's blocked blooms).
        self.filter_bits = 8 * max(len(self.src), 1)
        h = (self.src.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
        self.filter = np.zeros(self.filter_bits, bool)
        self.filter[(h % np.uint64(self.filter_bits)).astype(np.int64)] = True

    def maybe_contains(self, v: int) -> bool:
        with np.errstate(over="ignore"):  # intentional u64 wraparound
            h = (np.uint64(v) * np.uint64(0x9E3779B97F4A7C15))
        return bool(self.filter[int(h % np.uint64(self.filter_bits))])

    @property
    def ne(self) -> int:
        return len(self.src)


class LSMKVStore:
    def __init__(self, n_vertices: int, mem_cap: int = 1 << 14,
                 level_factor: int = 10, l0_limit: int = 4,
                 n_levels: int = 5):
        self.n_vertices = n_vertices
        self.mem_cap = mem_cap
        self.level_factor = level_factor
        self.l0_limit = l0_limit
        self.n_levels = n_levels
        self.mem: List[tuple] = []          # the 'skip list' memtable
        self.levels: List[List[_Run]] = [[] for _ in range(n_levels)]
        self.io = IO()
        self._ts = 0

    # ---------------------------------------------------------------- write
    def _put(self, src, dst, prop, delete: bool):
        src = np.asarray(src, np.int64).ravel()
        dst = np.asarray(dst, np.int64).ravel()
        prop = (np.zeros(len(src), np.float32) if prop is None
                else np.asarray(prop, np.float32).ravel())
        for i in range(len(src)):
            self.mem.append((int(src[i]), int(dst[i]), self._ts, delete,
                             float(prop[i])))
            self._ts += 1
            if len(self.mem) >= self.mem_cap:
                self._flush()

    def insert_edges(self, src, dst, prop=None):
        self._put(src, dst, prop, delete=False)

    def delete_edges(self, src, dst):
        self._put(src, dst, None, delete=True)

    def _flush(self):
        if not self.mem:
            return
        a = np.array(self.mem, dtype=np.float64)
        run = _Run(a[:, 0].astype(np.int64), a[:, 1].astype(np.int64),
                   a[:, 2].astype(np.int64), a[:, 3].astype(bool),
                   a[:, 4].astype(np.float32))
        self.mem = []
        self.levels[0].append(run)
        self.io.write += run.ne * REC_BYTES
        if len(self.levels[0]) >= self.l0_limit:
            self._compact(0)

    def _compact(self, level: int):
        runs = self.levels[level] + self.levels[level + 1]
        if not runs:
            return
        self.io.read += sum(r.ne for r in runs) * REC_BYTES
        src = np.concatenate([r.src for r in runs])
        dst = np.concatenate([r.dst for r in runs])
        ts = np.concatenate([r.ts for r in runs])
        marker = np.concatenate([r.marker for r in runs])
        prop = np.concatenate([r.prop for r in runs])
        is_bottom = level + 1 == self.n_levels - 1
        if is_bottom:
            s, d, p = dedup_last(src, dst, ts, marker, prop)
            merged = _Run(s, d, np.zeros(len(s), np.int64),
                          np.zeros(len(s), bool), p)
        else:
            merged = _Run(src, dst, ts, marker, prop)
        self.levels[level] = []
        self.levels[level + 1] = [merged]
        self.io.write += merged.ne * REC_BYTES
        cap = self.mem_cap * (self.level_factor ** (level + 1))
        if merged.ne > cap and level + 2 < self.n_levels:
            self._compact(level + 1)

    # ----------------------------------------------------------------- read
    def neighbors(self, v: int) -> np.ndarray:
        recs = []
        for (s, d, t, m, p) in self.mem:
            if s == v:
                recs.append((d, t, m))
        self.io.read += max(1, len(self.mem) // BLOCK_BYTES)  # memtable walk
        for lvl in self.levels:
            for run in lvl:
                if run.ne == 0 or not run.maybe_contains(v):
                    continue
                lo = np.searchsorted(run.src, v, "left")
                hi = np.searchsorted(run.src, v, "right")
                # Each probed data block charges a full block read.
                self.io.read += BLOCK_BYTES * max(
                    1, int(np.ceil((hi - lo) * REC_BYTES / BLOCK_BYTES)))
                for i in range(lo, hi):
                    recs.append((int(run.dst[i]), int(run.ts[i]),
                                 bool(run.marker[i])))
        if not recs:
            return np.zeros(0, np.int64)
        arr = np.array(recs, np.int64)
        order = np.lexsort((arr[:, 1], arr[:, 0]))
        arr = arr[order]
        last = np.ones(len(arr), bool)
        last[:-1] = arr[:-1, 0] != arr[1:, 0]
        live = last & (arr[:, 2] == 0)
        return arr[live, 0]

    def snapshot_csr(self, charge_read: bool = True):
        srcs, dsts, tss, mks, prs = [], [], [], [], []
        if self.mem:
            a = np.array(self.mem, dtype=np.float64)
            srcs.append(a[:, 0].astype(np.int64))
            dsts.append(a[:, 1].astype(np.int64))
            tss.append(a[:, 2].astype(np.int64))
            mks.append(a[:, 3].astype(bool))
            prs.append(a[:, 4].astype(np.float32))
        for lvl in self.levels:
            for run in lvl:
                srcs.append(run.src)
                dsts.append(run.dst)
                tss.append(run.ts)
                mks.append(run.marker)
                prs.append(run.prop)
        if not srcs:
            z = np.zeros(0, np.int64)
            return to_csr(z, z, np.zeros(0, np.float32), self.n_vertices)
        src = np.concatenate(srcs)
        if charge_read:
            # KV traversal parses records one by one across all runs.
            self.io.read += len(src) * REC_BYTES
        s, d, p = dedup_last(src, np.concatenate(dsts), np.concatenate(tss),
                             np.concatenate(mks), np.concatenate(prs))
        return to_csr(s, d, p, self.n_vertices)

    def disk_bytes(self) -> int:
        return sum(r.ne for lvl in self.levels for r in lvl) * REC_BYTES
