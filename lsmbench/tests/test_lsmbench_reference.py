"""The plain reference on hand-built tiny graphs."""
import math

import numpy as np
import pytest
import torch

from lsmbench.reference import adjacency_of, bfs_hops, lww_csr, pagerank, sssp


def _t(x, dtype=torch.int32):
    return torch.tensor(x, dtype=dtype)


def test_last_writer_wins_by_stream_order():
    # (0,1) inserted then deleted; (0,2) inserted; (1,0) inserted twice
    # with two props (the later one wins); (2,2) deleted then inserted.
    src = _t([0, 0, 0, 1, 1, 2, 2])
    dst = _t([1, 2, 1, 0, 0, 2, 2])
    ins = torch.tensor([1, 1, 0, 1, 1, 0, 1], dtype=torch.bool)
    prop = torch.tensor([.1, .2, 0, .3, .4, 0, .5])
    voff, d, p = lww_csr(src, dst, ins, prop, 4)
    assert voff.tolist() == [0, 1, 2, 3, 3]
    assert d.tolist() == [2, 0, 2]
    assert p.tolist() == pytest.approx([.2, .4, .5])
    assert d.dtype == torch.int32 and p.dtype == torch.float32


def test_lww_sorted_by_source_then_destination():
    src = _t([3, 1, 3, 1, 0])
    dst = _t([0, 9, 2, 4, 7])
    ins = torch.ones(5, dtype=torch.bool)
    voff, d, _ = lww_csr(src, dst, ins, torch.zeros(5), 10)
    assert d.tolist() == [7, 4, 9, 0, 2]
    assert voff.tolist()[:5] == [0, 1, 3, 3, 5]


def test_adjacency_of_in_query_order():
    csr = (torch.tensor([0, 2, 2, 3]), _t([5, 6, 7]),
           torch.tensor([1., 2., 3.]))
    offs, d, p = adjacency_of(csr, np.array([2, 0, 1]))
    assert offs.tolist() == [0, 1, 3, 3]
    assert d.tolist() == [7, 5, 6]
    assert p.tolist() == [3., 1., 2.]


def test_pagerank_of_a_cycle_is_uniform_and_mass_is_kept():
    voff = torch.tensor([0, 1, 2, 3])
    dst = _t([1, 2, 0])
    x = pagerank(voff, dst, iters=10)
    assert x.dtype == torch.float64
    assert torch.allclose(x, torch.full((3,), 1 / 3, dtype=torch.float64))


def test_pagerank_pulls_along_stored_edges_and_spreads_dangling_mass():
    # 0 -> 1, vertex 1 has no edge.  One step from x = 1/2 each:
    # y[0] = x[1] / max(deg 1 = 0, 1) = 1/2, y[1] = 0, dangling = x[1].
    voff = torch.tensor([0, 1, 1])
    dst = _t([1])
    x = pagerank(voff, dst, iters=1, d=0.85)
    y0, dangling = 0.5, 0.5
    want0 = 0.15 / 2 + 0.85 * (y0 + dangling / 2)
    want1 = 0.15 / 2 + 0.85 * (0 + dangling / 2)
    assert x.tolist() == pytest.approx([want0, want1])


def test_bfs_counts_hops_towards_the_source():
    # Edges 0->1, 1->2, 3->2: hops from u to 2 along stored edges.
    voff = torch.tensor([0, 1, 2, 2, 3])
    dst = _t([1, 2, 2])
    hops = bfs_hops(voff, dst, 2)
    assert hops.dtype == torch.float32
    assert hops.tolist() == [2.0, 1.0, 0.0, 1.0]
    far = bfs_hops(voff, dst, 0)
    assert torch.equal(far, torch.tensor([0.0, 3.0e38, 3.0e38, 3.0e38],
                                         dtype=torch.float32))


def test_sssp_takes_the_lighter_path_and_clamps_negative_weights():
    # 0->1 (5), 0->2 (1), 2->1 (1), 3->1 (-2 counts as 0); to source 1.
    voff = torch.tensor([0, 2, 2, 3, 4])
    dst = _t([1, 2, 1, 1])
    prop = torch.tensor([5., 1., 1., -2.])
    d = sssp(voff, dst, prop, 1)
    assert d.tolist()[:4] == [2.0, 0.0, 1.0, 0.0]
    d0 = sssp(voff, dst, prop, 0)
    assert d0[0] == 0 and all(math.isinf(v) for v in d0.tolist()[1:])


def test_lower_precision_changes_the_answers():
    g = torch.Generator().manual_seed(3)
    n, e = 50, 400
    src = torch.randint(n, (e,), generator=g)
    key = torch.unique(src * n + torch.randint(n, (e,), generator=g))
    src, dst = (key // n).int(), (key % n).int()
    prop = torch.rand(len(key), generator=g)
    voff, d, p = lww_csr(src, dst, torch.ones(len(key), dtype=torch.bool),
                         prop, n)
    _, _, p_low = lww_csr(src, dst, torch.ones(len(key), dtype=torch.bool),
                          prop, n, prop_dtype=torch.bfloat16)
    assert not torch.equal(p, p_low.float())
    x64 = pagerank(voff, d, 10)
    x16 = pagerank(voff, d, 10, dtype=torch.bfloat16)
    assert float((x16.double() - x64).abs().sum() / x64.sum()) > 1e-4
