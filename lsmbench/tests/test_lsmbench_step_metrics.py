"""The readers of the program's step spans: a share of the window, a mean
a chunk and a mean a request, each None where its cell did no work or the
program has no such span."""
import pytest

from test_lsmbench_metrics import FakeRun, reader

INGEST_SHARES = {
    "apply_upload_pct.ingest": "store_apply_upload_seconds",
    "apply_claim_pct.ingest": "store_apply_claim_seconds",
    "apply_place_pct.ingest": "store_apply_place_seconds",
    "apply_wait_pct.ingest": "store_apply_wait_seconds",
    "compaction_merge_pct.ingest": "store_compaction_merge_seconds",
    "run_seal_pct.ingest": "store_run_seal_seconds",
}
READ_MEANS = {
    "resolve_sealed_ms.read": "read_resolve_sealed_seconds",
    "resolve_mem_ms.read": "read_resolve_mem_seconds",
    "resolve_host_ms.read": "read_resolve_host_seconds",
}
VIEW_MEANS = {
    "view_collect_ms.analytics": "analytics_view_collect_seconds",
    "view_merge_ms.analytics": "analytics_view_merge_seconds",
}


@pytest.mark.parametrize("name,hist", sorted(INGEST_SHARES.items()))
def test_ingest_step_is_a_share_of_the_window(name, hist):
    run = FakeRun([("ingest", 0, 1, 10, True)], 8.0,
                  obs={hist: (2.0, 40), "store_apply_seconds": (6.0, 40)})
    assert reader(name)(run) == pytest.approx(25.0)
    run.requests = [("ingest", 0, 1, 10, False)]
    assert reader(name)(run) is None
    # The parent's series alone: a program without the step span.
    run = FakeRun([("ingest", 0, 1, 10, True)], 8.0,
                  obs={"store_apply_seconds": (6.0, 40)})
    assert reader(name)(run) is None


def test_claim_rounds_are_a_mean_a_chunk():
    run = FakeRun([("ingest", 0, 1, 10, True)], 8.0,
                  obs={"store_apply_claim_rounds": (120.0, 40)})
    assert reader("claim_rounds.ingest")(run) == pytest.approx(3.0)
    assert reader("claim_rounds.ingest")(FakeRun(run.requests, 8.0)) is None
    run.requests = []
    assert reader("claim_rounds.ingest")(run) is None


@pytest.mark.parametrize("name,hist", sorted(READ_MEANS.items()))
def test_resolve_step_is_a_mean_a_chunk(name, hist):
    run = FakeRun([("read", 0, 1, 16384, True)] * 3, 8.0,
                  obs={hist: (1.5, 30), "read_resolve_seconds": (3.0, 30)})
    assert reader(name)(run) == pytest.approx(50.0)
    run.requests = []
    assert reader(name)(run) is None
    assert reader(name)(FakeRun([("read", 0, 1, 1, True)], 8.0)) is None


@pytest.mark.parametrize("name,hist", sorted(VIEW_MEANS.items()))
def test_view_step_is_a_mean_a_request(name, hist):
    # Four requests; the span ran three times (one request's snapshot had
    # a single source and no merge): the mean is over the requests.
    run = FakeRun([("analytics", 0, 1, 1, True)] * 4
                  + [("analytics", 1, 2, 1, False)], 8.0,
                  obs={hist: (0.6, 3)})
    assert reader(name)(run) == pytest.approx(150.0)
    run.requests = []
    assert reader(name)(run) is None
    assert reader(name)(FakeRun([("analytics", 0, 1, 1, True)],
                                8.0)) is None
