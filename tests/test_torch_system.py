"""End-to-end behaviour of the port against the JAX package's: the two
cases of the reference's ``tests/test_system.py``.

Each workflow runs once through a JAX ``LSMGraph`` and once through a port
``LSMGraph`` on the CPU, on the same generated streams (the port's
``repro_torch.data`` generators, byte-equal to the reference's by
``test_torch_service.py``).  The materialized CSRs, degrees and BFS
distances must be equal; PageRank sums float32 values in another order in
each package: rtol 1e-5 / atol 1e-7 (``test_torch_analytics.py``'s
tolerance).  The reference's own assertions must hold on the port's
values.  The JAX side's analytics run their plain versions
(``use_pallas=False``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import small_store_cfg  # noqa: E402
from repro import analytics as jan  # noqa: E402
from repro.core import LSMGraph as JaxGraph  # noqa: E402
from repro_torch import analytics as pan  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402
from repro_torch.data import (powerlaw_edges, rmat_edges,  # noqa: E402
                              update_stream)

pytestmark = pytest.mark.slow

PR_TOL = dict(rtol=1e-5, atol=1e-7)


def _pair(**kw):
    cfg = small_store_cfg(**kw)
    return (JaxGraph(cfg),
            LSMGraph(StoreConfig(**dataclasses.asdict(cfg)), device="cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _views(gs, n):
    out = []
    for g, an in zip(gs, (jan, pan)):
        with g.snapshot() as snap:
            out.append(an.materialize_csr(snap, n))
    return out


def _same_csr(jv, pv):
    assert pv.n_edges == jv.n_edges
    for f in ("voff", "dst", "prop"):
        np.testing.assert_array_equal(_np(getattr(pv, f)),
                                      _np(getattr(jv, f)), err_msg=f)


def _pagerank(jv, pv):
    want = _np(jan.pagerank(jv, iters=10, use_pallas=False))
    got = _np(pan.pagerank(pv, iters=10))
    np.testing.assert_allclose(got, want, **PR_TOL)
    return got


def test_end_to_end_ingest_analyze_update_analyze():
    """The paper's full workflow: bulk load -> analyze -> stream updates
    (with deletes) -> analyze again on a fresh consistent snapshot."""
    V = 500
    gs = _pair(vmax=512)
    u, w = powerlaw_edges(V, 4000, seed=0)
    for g in gs:
        g.insert_edges(np.r_[u, w], np.r_[w, u])
    jv1, pv1 = _views(gs, V)
    _same_csr(jv1, pv1)
    pr1 = _pagerank(jv1, pv1)
    assert abs(pr1.sum() - 1) < 1e-3

    # streamed mixed updates (20:1 inserts:deletes, paper default)
    u2, w2 = powerlaw_edges(V, 2000, seed=9)
    for op, s, d in update_stream(u2, w2):
        for g in gs:
            if op == "insert":
                g.insert_edges(np.r_[s, d], np.r_[d, s])
            else:
                g.delete_edges(np.r_[s, d], np.r_[d, s])

    jv2, pv2 = _views(gs, V)
    _same_csr(jv2, pv2)
    pr2 = _pagerank(jv2, pv2)
    want = _np(jan.bfs(jv2, int(u[0]), use_pallas=False))
    dist = _np(pan.bfs(pv2, int(u[0])))
    np.testing.assert_array_equal(dist, want)
    assert abs(pr2.sum() - 1) < 1e-3
    assert pv2.n_edges > pv1.n_edges        # net growth
    assert (dist[_np(pv2.degrees) > 0] < 1e30).mean() > 0.5


def test_rmat_power_law_ingest():
    src, dst = rmat_edges(9, 8000, seed=2)
    gs = _pair(vmax=512)
    for g in gs:
        g.insert_edges(src, dst)
    jv, pv = _views(gs, 512)
    _same_csr(jv, pv)
    deg = _np(pv.degrees)
    # power-law-ish: the top-1% of vertices hold a large share of edges
    top = np.sort(deg)[-5:].sum()
    assert top > 0.05 * deg.sum()
    assert pv.n_edges > 0
