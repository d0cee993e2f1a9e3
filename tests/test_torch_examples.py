"""The port's examples (``repro_torch.examples``) against the reference's
scripts (``examples/``), on the CPU.

``quickstart`` must print the reference's values: the first neighbours of
vertex 0, the live edge count, the vertices BFS reaches, the level sizes
and the I/O counters byte for byte, and PageRank's top 5 equal but where
two scores tie within 1e-6 relative.  ``streaming_updates`` must end with
the reference's live edge set on the same stream (its timings and the
number of concurrent PageRank runs depend on the threads' timing).
"""
import contextlib
import io
import re
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import quickstart, streaming_updates  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while each test runs (restored after): the
    suite runs several workers on one machine, where every worker's
    spinning OpenMP threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_reference(script):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        env = runpy.run_path(str(ROOT / "examples" / script),
                             run_name="__main__")
    return buf.getvalue(), env


def _lines(text):
    return dict(line.split(":", 1) for line in text.splitlines()
                if ":" in line)


def _top(text):
    return [int(x) for x in re.findall(r"\d+", text)]


def test_quickstart_prints_the_reference_values():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        quickstart.main(["--device", "cpu"])
    got = _lines(buf.getvalue())
    want_text, env = _run_reference("quickstart.py")
    want = _lines(want_text)
    assert set(got) == set(want) == {
        "neighbors(0)", "live edges", "top PageRank", "BFS reached",
        "level sizes", "io counters"}
    for key in ("neighbors(0)", "live edges", "BFS reached", "level sizes",
                "io counters"):
        assert got[key] == want[key], key
    pr = np.asarray(env["pr"], np.float64)
    for a, b in zip(_top(got["top PageRank"]), _top(want["top PageRank"])):
        if a != b:       # a tie within 1e-6 relative may order either way
            assert abs(pr[a] - pr[b]) <= 1e-6 * max(abs(pr[a]), abs(pr[b]))


def test_streaming_updates_ends_with_the_reference_edge_set():
    lines = []
    got = streaming_updates.run("cpu", log=lambda *a: lines.append(
        " ".join(str(x) for x in a)))
    assert lines[0].startswith("streamed ")
    _, env = _run_reference("streaming_updates.py")
    ref = env["g"].store
    with ref.snapshot() as snap:
        want = snap.edge_set()
    assert len(want) > 5000
    assert got == want
