"""The port's merge-free multi-level analytics held against the JAX
package's, and the multi-run segment sum against its per-run definition.

One stream goes through ``repro.core.LSMGraph`` and
``repro_torch.core.LSMGraph(device="cpu")``: random directed edges over
V = 300 vertices, each inserted once, in five flushed parts with a
partial compaction after the third, and deletes of earlier parts along
the way, so the snapshot holds an L0 run, L1 runs, an L2 run and a
MemGraph of tombstones, all sharing source vertices.  The JAX side sums one
``gather_segsum`` a run (its Pallas kernel in interpret mode, as its own
tests run it); the port makes one multi-run sweep.

Tolerances: degrees are sums of +1 and -1, exact in any order: equal.
``multilevel_spmv`` and ``multilevel_pagerank`` add float32 values in
another order in each package: rtol 1e-5 with atol 1e-7 (``PR_TOL`` of
``tests/test_torch_analytics.py``; PageRank values are near 1/V = 3.3e-3).
``gather_segsum_runs_ref`` against the sum of per-run ``gather_segsum_ref``
calls runs on integer-valued weights and x, where every float32 partial is
exact: equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from conftest import small_store_cfg  # noqa: E402
from repro import analytics as jan  # noqa: E402
from repro.core import LSMGraph as JaxGraph  # noqa: E402
from repro_torch import analytics as pan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analytics import multilevel as pml  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import segment_reduce as segred  # noqa: E402

V = 300
PR_TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(5)
    key = np.unique(rng.integers(0, V * V, 2400))
    rng.shuffle(key)
    u, w = key // V, key % V
    kw = dataclasses.asdict(small_store_cfg(vmax=V, l0_run_limit=2,
                                            seg_target_edges=256))
    pair = (JaxGraph(small_store_cfg(**kw)),
            LSMGraph(StoreConfig(**kw), device="cpu"))
    parts = np.array_split(np.arange(len(u)), 6)
    for g in pair:
        for i, p in enumerate(parts[:5]):
            g.insert_edges(u[p], w[p])
            if i:
                gone = parts[i - 1][:60]
                g.delete_edges(u[gone], w[gone])
            g.flush_memgraph()
            if i == 2:
                g.compact_partial(1)
        gone = parts[4][:40]
        g.delete_edges(u[gone], w[gone])   # tombstones in the MemGraph
    snaps = [g.snapshot() for g in pair]
    views = (jan.multilevel_views(snaps[0]), pan.multilevel_views(snaps[1]))
    yield pair, snaps, views
    for s in snaps:
        s.release()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_store_spans_every_tier(stores):
    (jg, pg), _, (jviews, pviews) = stores
    runs = [len(lvl) for lvl in pg.levels]
    assert runs[0] >= 1 and runs[1] >= 2 and runs[2] >= 1
    assert pg.n_edges_cached() > 0
    assert [len(lvl) for lvl in jg.levels] == runs
    assert len(pviews) == len(jviews) == sum(runs) + 1
    for jrv, prv in zip(jviews, pviews):
        crv = convert.run_view_to_torch(jrv, "cpu")
        for f in prv._fields:
            assert torch.equal(getattr(prv, f), getattr(crv, f)), f
    assert any(bool((rv.wt < 0).any()) for rv in pviews)   # tombstones
    srcs = [set(rv.src.tolist()) for rv in pviews]
    assert any(a & b for i, a in enumerate(srcs) for b in srcs[i + 1:])


def test_multilevel_degree_matches_jax(stores):
    _, _, (jviews, pviews) = stores
    got = _np(pan.multilevel_degree(pviews, n_out=V))
    want = np.asarray(jan.multilevel_degree(jviews, n_out=V))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0


@pytest.mark.parametrize("seed", [0, 1])
def test_multilevel_spmv_matches_jax(stores, seed):
    _, _, (jviews, pviews) = stores
    x = np.random.default_rng(seed).random(V).astype(np.float32)
    got = _np(pan.multilevel_spmv(pviews, torch.from_numpy(x), n_out=V))
    want = np.asarray(jan.multilevel_spmv(jviews, jnp.asarray(x), n_out=V))
    np.testing.assert_allclose(got, want, **PR_TOL)
    plain = _np(pan.multilevel_spmv(pviews, torch.from_numpy(x), n_out=V,
                                    use_pallas=False))
    np.testing.assert_array_equal(got, plain)


def test_multilevel_pagerank_matches_jax(stores):
    _, snaps, (jviews, pviews) = stores
    got = _np(pan.multilevel_pagerank(pviews, n_out=V, iters=10))
    want = np.asarray(jan.multilevel_pagerank(jviews, n_out=V, iters=10))
    np.testing.assert_allclose(got, want, **PR_TOL)
    merged = _np(pan.pagerank(pan.materialize_csr(snaps[1], V), iters=10))
    np.testing.assert_allclose(got, merged, **PR_TOL)


def test_run_batch_lays_views_end_to_end(stores):
    _, _, (_, pviews) = stores
    batch = pml.run_batch(pviews)
    assert batch.offsets.dtype == torch.int64
    assert batch.offsets.tolist() == np.cumsum(
        [0] + [rv.src.shape[0] for rv in pviews]).tolist()
    for r, rv in enumerate(pviews):
        lo, hi = int(batch.offsets[r]), int(batch.offsets[r + 1])
        for f in ("src", "dst", "wt"):
            assert torch.equal(getattr(batch, f)[lo:hi], getattr(rv, f)), f
    empty = pml.run_batch([], "cpu")
    assert empty.offsets.tolist() == [0] and empty.src.shape == (0,)
    assert torch.equal(pan.multilevel_spmv([], torch.ones(V), n_out=V),
                       torch.zeros(V))


def _runs_case(seed):
    """Runs sorted by source id within each run: ids recurring in several
    runs, one run ending and the next beginning with the same id, an empty
    run, -1 tombstones, zero weights, ids >= n_out (dropped) and dst out of
    range (clipped).  Integer weights and x: every partial sum is exact."""
    rng = np.random.default_rng(seed)
    n_out, n_x = 40, 37
    runs = []
    for size in (50, 0, 33, 1, 120, 64):
        seg = np.sort(rng.integers(0, n_out + 3, size))
        runs.append(seg.astype(np.int32))
    runs[3][:] = runs[2][-1]                   # same id across a boundary
    runs[5][:20] = runs[4][-1]
    runs[5].sort()
    segs = [torch.from_numpy(s) for s in runs]
    dsts = [torch.from_numpy(rng.integers(-2, n_x + 2, len(s))
                             .astype(np.int32)) for s in runs]
    wts = [torch.from_numpy(rng.choice([1.0, -1.0, 0.0, 2.0], len(s))
                            .astype(np.float32)) for s in runs]
    x = torch.from_numpy(rng.integers(-3, 4, n_x).astype(np.float32))
    return segs, dsts, wts, x, n_out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_segsum_runs_ref_is_sum_of_per_run_calls(seed):
    segs, dsts, wts, x, n_out = _runs_case(seed)
    want = torch.zeros(n_out)
    for s, d, w in zip(segs, dsts, wts):
        want += segred.gather_segsum_ref(d, s, w, x, n_out)
    args = (torch.cat(dsts), torch.cat(segs), torch.cat(wts), x)
    got = segred.gather_segsum_runs_ref(*args, n_out)
    assert torch.equal(got, want)
    ops.reset_launches()
    assert torch.equal(ops.gather_segsum_runs(*args, n_out=n_out), want)
    assert torch.equal(ops.gather_segsum_runs(*args, n_out=n_out,
                                              use_pallas=False), want)
    assert ops.launch_counts()["gather_segsum_runs"] == 0   # CPU tensors


def test_gather_segsum_runs_cuda_refuses_cpu_tensors():
    segs, dsts, wts, x, n_out = _runs_case(0)
    with pytest.raises(ValueError, match="CUDA"):
        segred.gather_segsum_runs_cuda(torch.cat(dsts), torch.cat(segs),
                                       torch.cat(wts), x, n_out)
