"""The benchmark's own spans and the device trace of a slice of the window.

Spans: ``span(log, name)`` puts a ``torch.profiler.record_function`` range
named ``lsmbench.<name>`` around a call into a layer and records its host
time, which ends in ``torch.cuda.synchronize()`` where asked (``sync``):
in a traced run, for the spans that a per-layer metric reads.

Device trace: one client thread starts ``torch.profiler`` between two of
its requests once the slice's start has passed and stops it after its
last request (the profiler records the host ranges of the thread that
started it, and the device's work of every thread).  ``summarize`` turns
the trace into what the metric readers and the result line read: the
device's busy time (the union of its kernels, copies and sets), each
device operation's interval, and the idle gaps named by what the
profiled thread was doing.
"""
from __future__ import annotations

import bisect
import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

PREFIX = "lsmbench."


class SpanLog:
    """Host seconds of each named span, from every thread."""

    def __init__(self, device) -> None:
        self.cuda = torch.device(device).type == "cuda"
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self._mu = threading.Lock()

    def add(self, name: str, dt: float) -> None:
        with self._mu:
            self.seconds[name].append(dt)


@contextlib.contextmanager
def span(log: SpanLog, name: str, sync: bool = True):
    with torch.profiler.record_function(PREFIX + name):
        t0 = time.perf_counter()
        yield
        if sync and log.cuda:
            torch.cuda.synchronize()
        log.add(name, time.perf_counter() - t0)


class Slice:
    """Profiles the last ``seconds`` of the window from the thread that
    calls ``tick`` between its requests: from its first request boundary
    at or after ``start`` to the end of its loop, so that the profiler's
    own stop, which processes the trace, falls after the window."""

    def __init__(self, start: float, cuda: bool) -> None:
        self.start = start
        self.cuda = cuda
        self.prof = None
        self.t_on = self.t_off = None
        self.stop_s = 0.0

    def tick(self, now: float) -> None:
        if self.prof is None and now >= self.start:
            self.prof = profile(self.cuda)
            self.prof.start()
            self.t_on = time.perf_counter()

    def close(self) -> None:
        if self.prof is not None and self.t_off is None:
            if self.cuda:
                torch.cuda.synchronize()
            self.t_off = time.perf_counter()
            self.prof.stop()
            self.stop_s = time.perf_counter() - self.t_off


def profile(cuda: bool):
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return torch.profiler.profile(activities=acts)


def warm_profiler(cuda: bool) -> None:
    """Start and stop the profiler once in this (the main) thread: the
    profiler's first start registers it with the thread that makes it,
    and a later start in a client thread then records that thread."""
    with profile(cuda):
        torch.ones(8, device="cuda" if cuda else "cpu").sum()
        if cuda:
            torch.cuda.synchronize()


def _host_segments(events):
    """The profiled thread's host ranges flattened into segments, each
    labelled by its outermost ``lsmbench.`` range and its innermost op:
    sorted (start, end, label) with no overlap."""
    evs = sorted(events, key=lambda e: (e[0], -e[1]))
    segs = []
    stack = []   # (end, name)

    def emit(lo, hi):
        if hi <= lo:
            return
        outer = next((n for _, n in stack if n.startswith(PREFIX)), None)
        inner = stack[-1][1] if stack else None
        if outer is None:
            label = "outside the benchmark's ranges"
        elif inner == outer:
            label = outer + " > python"
        else:
            label = f"{outer} > {inner}"
        segs.append((lo, hi, label))

    def close_until(when):
        nonlocal t
        while stack and stack[-1][0] <= when:
            end = max(stack[-1][0], t)
            emit(t, end)
            t = end
            stack.pop()

    t = evs[0][0] if evs else 0.0
    for lo, hi, name in evs:
        close_until(lo)
        emit(t, lo)
        t = max(t, lo)
        stack.append((hi, name))
    close_until(float("inf"))
    return segs


def _blocks(intervals):
    """Merge sorted (lo, hi) intervals into disjoint busy blocks."""
    out = []
    for lo, hi in intervals:
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def summarize(sl: Slice) -> Optional[dict]:
    """What the trace shows, or None when no slice was profiled."""
    if sl.prof is None or sl.t_off is None:
        return None
    from torch.autograd import DeviceType
    device, host = [], []
    for e in sl.prof.profiler.kineto_results.events():
        lo, hi = e.start_ns() / 1e9, e.end_ns() / 1e9
        if e.device_type() == DeviceType.CUDA:
            # The device's copy of a host range is no device work.
            if not e.name().startswith(PREFIX) and not getattr(
                    e, "is_user_annotation", lambda: False)():
                device.append((lo, hi, e.name()))
        elif e.device_type() == DeviceType.CPU and hi >= lo:
            host.append((lo, hi, e.name(), e.start_thread_id()))
    device.sort()
    blocks = _blocks((lo, hi) for lo, hi, _ in device)
    by_op: Dict[str, float] = defaultdict(float)
    for lo, hi, name in device:
        by_op[name] += hi - lo
    # The device's idle gaps inside the profiled thread's host ranges,
    # each named by what that thread was doing at the gap's middle.
    ranges = defaultdict(int)
    for _, _, name, tid in host:
        if name.startswith(PREFIX):
            ranges[tid] += 1
    gaps: Dict[str, float] = defaultdict(float)
    if ranges:
        tid = max(ranges, key=ranges.get)
        segs = _host_segments([(lo, hi, name) for lo, hi, name, t in host
                               if t == tid])
        starts = [s[0] for s in segs]
        first, last = segs[0][0], segs[-1][1]
        edges = [first] + [x for b in blocks for x in b] + [last]
        for lo, hi in zip(edges[0::2], edges[1::2]):
            lo, hi = max(lo, first), min(hi, last)
            if hi <= lo:
                continue
            mid = (lo + hi) / 2
            i = bisect.bisect_right(starts, mid) - 1
            label = (segs[i][2] if i >= 0 and segs[i][1] >= mid
                     else "outside the benchmark's ranges")
            gaps[label] += hi - lo
    return dict(window_s=sl.t_off - sl.t_on,
                busy_s=sum(hi - lo for lo, hi in blocks), device=device,
                device_ops=sorted(by_op.items(), key=lambda kv: -kv[1]),
                idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]))
