"""MBFGraph-style baseline: append-only edge log.

Ingest is a raw append (the 'cat >> file' throughput the paper measures at
3e7 edges/s); but the edge-centric read path scans the ENTIRE log for every
analytics pass, and point reads filter the whole log too.
"""
from __future__ import annotations

import numpy as np

from .common import IO, REC_BYTES, dedup_last, to_csr


class LogAppend:
    def __init__(self, n_vertices: int):
        self.n_vertices = n_vertices
        self.chunks = []
        self.n = 0
        self.io = IO()
        self._ts = 0

    def _edit(self, src, dst, prop, delete: bool):
        src = np.asarray(src, np.int64).ravel()
        dst = np.asarray(dst, np.int64).ravel()
        prop = (np.zeros(len(src), np.float32) if prop is None
                else np.asarray(prop, np.float32).ravel())
        ts = np.arange(self._ts, self._ts + len(src), dtype=np.int64)
        self._ts += len(src)
        self.chunks.append((src, dst, ts, np.full(len(src), delete), prop))
        self.n += len(src)
        self.io.write += len(src) * REC_BYTES

    def insert_edges(self, src, dst, prop=None):
        self._edit(src, dst, prop, delete=False)

    def delete_edges(self, src, dst):
        self._edit(src, dst, None, delete=True)

    def _all(self):
        if not self.chunks:
            z = np.zeros(0, np.int64)
            return z, z, z, np.zeros(0, bool), np.zeros(0, np.float32)
        return (np.concatenate([c[0] for c in self.chunks]),
                np.concatenate([c[1] for c in self.chunks]),
                np.concatenate([c[2] for c in self.chunks]),
                np.concatenate([c[3] for c in self.chunks]),
                np.concatenate([c[4] for c in self.chunks]))

    def neighbors(self, v: int) -> np.ndarray:
        src, dst, ts, marker, prop = self._all()
        self.io.read += self.n * REC_BYTES   # full-log scan per read
        m = src == v
        s, d, p = dedup_last(src[m], dst[m], ts[m], marker[m], prop[m])
        return d

    def snapshot_csr(self, charge_read: bool = True):
        src, dst, ts, marker, prop = self._all()
        if charge_read:
            self.io.read += self.n * REC_BYTES
        s, d, p = dedup_last(src, dst, ts, marker, prop)
        return to_csr(s, d, p, self.n_vertices)

    def disk_bytes(self) -> int:
        return self.n * REC_BYTES
