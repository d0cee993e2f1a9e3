"""Graph generators for the port's smoke run and tests (numpy only).

A copy of the three generators of the JAX package's ``repro.data.graphgen``
that the port uses: Zipf-weighted power-law edges (the graph service's
stream), R-MAT with (0.57, 0.19, 0.19, 0.05) — the Graph500 Kernel 1
generator's skew — and the paper's 20:1 insert/delete update stream.  Same
seeds give the same edges as the reference, byte for byte.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def powerlaw_edges(n_vertices: int, n_edges: int, *, alpha: float = 1.2,
                   seed: int = 0, unique: bool = True
                   ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    # Zipf-weighted endpoints.
    w = 1.0 / np.arange(1, n_vertices + 1) ** alpha
    w /= w.sum()
    m = int(n_edges * 1.3) if unique else n_edges
    src = rng.choice(n_vertices, m, p=w).astype(np.int64)
    dst = rng.choice(n_vertices, m, p=w).astype(np.int64)
    if unique:
        key = src * n_vertices + dst
        _, idx = np.unique(key, return_index=True)
        idx = np.sort(idx)[:n_edges]
        src, dst = src[idx], dst[idx]
    perm = rng.permutation(len(src))
    return src[perm].astype(np.int32), dst[perm].astype(np.int32)


def rmat_edges(scale: int, n_edges: int, *, seed: int = 0,
               a=0.57, b=0.19, c=0.19) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    for bit in range(scale):
        r = rng.random(n_edges)
        go_right = r > a + b                      # src bit
        go_down = ((r > a) & (r <= a + b)) | (r > a + b + c)  # dst bit
        src = (src << 1) | go_right
        dst = (dst << 1) | go_down
    return src.astype(np.int32), dst.astype(np.int32)


def update_stream(src: np.ndarray, dst: np.ndarray, *, delete_ratio:
                  float = 1 / 21, seed: int = 0, chunk: int = 4096
                  ) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
    """Mixed insert/delete stream (paper: 20:1 inserts to deletes).

    Deletes only target previously-inserted edges (alternating histories).
    ``chunk`` is the insert run length between delete bursts; the default
    4096 is the JAX package's fixed value and gives its stream."""
    rng = np.random.default_rng(seed)
    inserted_at = 0
    for off in range(0, len(src), chunk):
        s, d = src[off:off + chunk], dst[off:off + chunk]
        yield "insert", s, d
        inserted_at = off + len(s)
        n_del = int(len(s) * delete_ratio)
        if n_del and inserted_at > chunk:
            pick = rng.integers(0, inserted_at, n_del)
            yield "delete", src[pick], dst[pick]
