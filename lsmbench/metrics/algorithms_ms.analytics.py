"""algorithms_ms.analytics, ms (benchmark spans, each ending in a
synchronize): PageRank, BFS and SSSP of a request, the mean over the
window's requests."""

STEPS = ("analytics.pagerank", "analytics.bfs", "analytics.sssp")


def read(run):
    n = len(run.done("analytics"))
    if not n:
        return None
    return sum(sum(run.spans.seconds.get(s, ())) for s in STEPS) / n * 1e3
