"""The metric arithmetic: rates over the whole window, the p95 over every
request, the spread, the segment kernels' bytes and roofline share, the
idle share, and the comparison of adjacency lists."""
import statistics

import numpy as np
import pytest

from lsmbench import spec, stats
from lsmbench.ops.common import compare_lists
from lsmbench.roofline import (HBM_BYTES_PER_S, bound_seconds,
                               segment_reduce_bytes)


class FakeRun:
    """The readings a metric reader takes from a run."""

    def __init__(self, requests, window_s, profile=None, info=None,
                 obs=None, spans=None):
        self.requests = requests
        self.window_s = window_s
        self.setup_s = 12.5
        self.profile = profile
        self.info = info or {}
        self.obs_delta = obs or {}
        self.spans = type("S", (), {"seconds": spans or {}})()

    def done(self, op):
        return [r for r in self.requests if r[0] == op and r[4]]

    def units(self, op):
        return sum(r[3] for r in self.done(op))

    def latencies(self, op):
        return [r[2] - r[1] for r in self.done(op)]

    def obs_sum(self, name):
        return self.obs_delta.get(name, (0.0, 0))[0]

    def obs_count(self, name):
        return self.obs_delta.get(name, (0.0, 0))[1]


def reader(name):
    return spec.load_reader(spec.metric_path(name))


def test_rate_over_the_whole_window():
    reqs = [("ingest", 0.0, 1.0, 100, True), ("ingest", 1.0, 2.5, 300, True),
            ("ingest", 2.5, 3.0, 50, False)]
    run = FakeRun(reqs, window_s=4.0)
    # Failed calls add no records; idle time at the end still counts.
    assert reader("ingest_rate")(run) == pytest.approx(400 / 4.0)
    assert stats.rate(400, 4.0) == 100.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_is_over_every_request_not_a_median_of_pieces():
    lat = [0.1] * 90 + [1.0] * 10
    reqs = [("read", 0.0, x, 16, True) for x in lat]
    got = reader("read_p95_ms")(FakeRun(reqs, 10.0))
    want = statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
    assert got == pytest.approx(want)
    assert got > 500   # the slow tenth sets the tail
    assert stats.percentile([3.0], 95) == 3.0


def test_read_rate_and_analytics_time():
    reqs = [("read", 0, 1, 16384, True)] * 30
    assert reader("read_rate")(FakeRun(reqs, 10.0)) == 30 * 16384 / 10.0
    reqs = [("analytics", 0, 1, 1, True)] * 25
    assert reader("analytics_ms")(FakeRun(reqs, 10.0)) == 400.0
    assert reader("analytics_ms")(FakeRun([], 10.0)) is None


def test_spread_is_the_quartile_distance_over_the_median():
    vals = [10.0, 10.2, 9.8, 10.1, 9.9, 10.0]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)


def test_segment_bytes_are_twelve_an_edge_and_eight_a_vertex():
    assert segment_reduce_bytes(63_000_000, 4_194_304) == \
        12 * 63_000_000 + 8 * 4_194_304
    # Phase 4's view (PERF.md): 0.2395 ms at 3.35 TB/s.
    e = (0.2395e-3 * HBM_BYTES_PER_S - 8 * 4_194_304) / 12
    assert bound_seconds(segment_reduce_bytes(e, 4_194_304)) == \
        pytest.approx(0.2395e-3, rel=1e-3)


def test_roofline_counts_each_launch_with_its_fill():
    e, n = 1_000_000, 100_000
    b = bound_seconds(segment_reduce_bytes(e, n))
    sum_k = "void (anonymous namespace)::seg_reduce_kernel<(anonymous " \
            "namespace)::SumOp>(int const*)"
    min_k = sum_k.replace("SumOp", "MinOp")
    fill = "(anonymous namespace)::fill_kernel(float*, int, float)"
    dev = [(0.0, 0.1 * b, fill), (0.1 * b, 2.0 * b, sum_k),
           (3.0, 3.0 + 0.1 * b, fill), (3.0 + 0.1 * b, 3.0 + 4.0 * b, min_k),
           (5.0, 5.0 + b, "other")]
    run = FakeRun([], 10.0, profile={"device": dev, "busy_s": 1.0,
                                     "window_s": 4.0},
                  info={"segment_view": (e, n)})
    assert reader("gather_segsum_roofline")(run) == pytest.approx(50.0)
    assert reader("gather_segmin_roofline")(run) == pytest.approx(25.0)
    assert reader("device_idle_pct.analytics")(run) == pytest.approx(75.0)
    run.profile = None
    assert reader("gather_segsum_roofline")(run) is None
    assert reader("device_idle_pct.ingest")(run) is None


def test_layer_shares_from_program_spans():
    reqs = [("ingest", 0, 1, 10, True)]
    obs = {"store_apply_seconds": (6.0, 100), "store_flush_seconds": (1.0, 3),
           "store_compaction_seconds": (2.0, 2),
           "read_resolve_seconds": (3.0, 30)}
    run = FakeRun(reqs, 10.0, obs=obs)
    assert reader("memgraph_insert_pct.ingest")(run) == pytest.approx(60.0)
    assert reader("flush_compaction_pct.ingest")(run) == pytest.approx(30.0)
    run.requests = [("read", 0, 1, 10, True)]
    assert reader("resolve_ms.read")(run) == pytest.approx(100.0)


def test_analytics_spans_are_means_per_request():
    reqs = [("analytics", 0, 1, 1, True)] * 2
    spans = {"analytics.materialize_csr": [0.3, 0.5],
             "analytics.pagerank": [0.01, 0.01], "analytics.bfs": [0.02],
             "analytics.sssp": [0.04, 0.02]}
    run = FakeRun(reqs, 1.0, spans=spans)
    assert reader("materialize_ms.analytics")(run) == pytest.approx(400.0)
    assert reader("algorithms_ms.analytics")(run) == pytest.approx(50.0)


def _lists(pairs):
    offs = np.r_[0, np.cumsum([len(d) for d, _ in pairs])]
    return (offs, np.concatenate([d for d, _ in pairs]).astype(np.int32),
            np.concatenate([p for _, p in pairs]).astype(np.float32))


def test_compare_lists_counts_vertices_and_props():
    want = _lists([([1, 2], [.5, .25]), ([], []), ([7], [1.0])])
    assert [c.value for c in compare_lists(want, want)] == [0, 0]
    # A dropped edge, a changed prop on another vertex, an extra edge.
    got = _lists([([1], [.5]), ([3], [0.0]), ([7], [1.5])])
    lists, props = compare_lists(got, want)
    assert (lists.value, props.value) == (2, 1)
    assert not lists.ok and not props.ok and lists.limit == 0
    # Same degree, other destinations.
    got = _lists([([1, 3], [.5, .25]), ([], []), ([7], [1.0])])
    assert [c.value for c in compare_lists(got, want)] == [1, 0]
    # -0.0 against +0.0 is a different prop to the bit.
    got = _lists([([1, 2], [.5, .25]), ([], []), ([7], [1.0])])
    z = _lists([([1, 2], [.5, .25]), ([], []), ([7], [1.0])])
    z[2][0] = -0.0
    got[2][0] = 0.0
    assert compare_lists(got, z)[1].value == 1
