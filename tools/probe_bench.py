#!/usr/bin/env python3
"""Time the read path's probe kernels, ``csrc/presence.cu`` and
``csrc/lookup.cu``, on one NVIDIA GPU at the main path's shapes.

    python3 tools/probe_bench.py [--parent-presence OLD.cu]
        [--parent-lookup OLD.cu] [--parent-wrappers DIR] [--o0] [--seed N]

Shapes:

- ``presence_matrix``: ``chip_smoke.presence_inputs``, phase 2's filters
  (2 runs of 600,000 keys and 2,046 of 4,000: 5,238,784 words) and 16,384
  queries.  Probe: every row cut to ``FILTER_MIN_BITS`` (mask 255, so all
  probes of a row fall in its first 8 words).
- ``batched_searchsorted``: a run of 504,073 distinct sorted vertex ids of
  R-MAT scale 22 in a vkeys buffer of 4,194,304 slots (INVALID_VID pads),
  the shape of the L0 run that ``chip_smoke.py`` phase 5 probes, and 65,600
  queries (65,536 random vertices and 64 keys).  Probes: n_keys 2,048 (the
  whole search in L1) and every query equal.  The wrapper's host cost is
  split into its parts by the host clock.
- ``batched_searchsorted_runs``: the ``RUNS`` below, laid end to end, and
  the same 65,600 queries.

Each kernel is checked byte-equal against its plain version, then timed by
CUDA events (back-to-back calls: the wrapper's dispatch included) and by
``torch.profiler`` (the kernel's device time), beside its byte bound.
``--parent-presence`` and ``--parent-lookup`` build an earlier source with
the same C entry points under another library name, check it and time it
against the checkout's in turns: parent, new, new, parent.  Without
``--parent-wrappers`` an earlier build is called bare, through its C entry
point; with it, ``DIR/presence.py`` and ``DIR/lookup.py`` (earlier
``kernels/`` wrappers) are loaded against the earlier builds, and the turns
time the earlier wrapper's whole call against the checkout's, by events,
device time and host µs a call.  ``--o0`` builds the checkout's sources at
``-Xptxas -O0`` as well and holds those builds against the plain versions.
Fails without a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from segment_bench import nvcc_build  # noqa: E402

LOOKUP_N, LOOKUP_CAP, LOOKUP_Q = 504_073, 1 << 22, 65_600
# (runs, keys a run, slots a run) of the multi-run bench: 1,935 runs like
# the phase-5 store's at seed 0 (one L0 run; a median of 432 keys a run; 108
# runs above 4,096 keys; 2,487,891 keys in all), one L0 run over the whole
# vertex range, then two groups of runs, each over disjoint equal slices of
# it (segments of the vertex range, as the store's L1+ runs are).
RUNS = ((1, LOOKUP_N, LOOKUP_CAP), (1_826, 432, 512), (108, 11_000, 1 << 14))

def entries(lib, module):
    """The entry points of ``lib``, a build of a kernel source, that
    ``module``'s wrapper declares, bound with its ``_PROTOTYPES``."""
    from repro_torch.kernels import _build
    return _build.bind_library(lib, {
        k: v for k, v in module._PROTOTYPES.items() if hasattr(lib, k)})


def presence_call(lib):
    """``presence_matrix_launch`` of a library built here, called bare:
    bool[R, B] allocated here."""
    import torch
    from repro_torch.core.filters import FILTER_K, FILTER_SALT
    from repro_torch.kernels import _build, presence
    fn = entries(lib, presence)["presence_matrix_launch"]

    def call(words, offs, masks, queries):
        out = torch.empty((offs.shape[0], queries.shape[0]),
                          dtype=torch.bool, device=queries.device)
        rc = _build.run_on(queries.device, fn, words.data_ptr(),
                           offs.data_ptr(), masks.data_ptr(),
                           queries.data_ptr(), out.data_ptr(), offs.shape[0],
                           queries.shape[0], FILTER_K, FILTER_SALT)
        _build.check(rc, "presence_matrix")
        return out
    return call


def lookup_call(lib):
    """``batched_searchsorted_launch`` of a library built here, called
    bare, with n_keys as a 1-element int32 tensor on the card."""
    import torch
    from repro_torch.kernels import _build, lookup
    fn = entries(lib, lookup)["batched_searchsorted_launch"]

    def call(keys, queries, n_keys):
        out = torch.empty(queries.shape, dtype=torch.int32,
                          device=queries.device)
        rc = _build.run_on(queries.device, fn, keys.data_ptr(),
                           queries.data_ptr(), n_keys.data_ptr(),
                           out.data_ptr(), queries.shape[0], keys.shape[0])
        _build.check(rc, "batched_searchsorted")
        return out
    return call


def runs_call(lib):
    """``batched_searchsorted_runs_launch`` of a library built here, called
    bare; None where the library has no such entry."""
    import torch
    from repro_torch.kernels import _build, lookup
    fn = entries(lib, lookup).get("batched_searchsorted_runs_launch")
    if fn is None:
        return None

    def call(keys, offs, n_keys, queries):
        out = torch.empty((offs.shape[0], queries.shape[0]),
                          dtype=torch.int32, device=queries.device)
        rc = _build.run_on(queries.device, fn, keys.data_ptr(),
                           offs.data_ptr(), n_keys.data_ptr(),
                           queries.data_ptr(), out.data_ptr(), offs.shape[0],
                           queries.shape[0], keys.shape[0])
        _build.check(rc, "batched_searchsorted_runs")
        return out
    return call


def parent_wrapper(path: Path, lib):
    """The module of an earlier wrapper source ``path`` (a ``kernels/*.py``
    of the port), its relative imports resolved in ``repro_torch.kernels``
    and every kernel it binds taken from ``lib``, an earlier build."""
    from repro_torch.kernels import _build
    spec = importlib.util.spec_from_file_location(
        f"repro_torch.kernels._parent_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fns = entries(lib, mod)
    shim = types.ModuleType("parent_build")
    shim.__dict__.update(vars(_build))
    shim.bind = lambda name, prototypes: fns
    mod._build = shim
    return mod


def runs_inputs(rng, dev):
    """(keys, int64 offs, int32 nv) of RUNS laid end to end: sorted
    distinct vertex ids of scale 22 in each run's slice of the range,
    INVALID_VID past each run's nv."""
    import torch
    from repro_torch.core.types import INVALID_VID
    parts, nvs = [], []
    for count, nv, cap in RUNS:
        width = (1 << cs.SCALE) // count
        for i in range(count):
            part = np.full(cap, INVALID_VID, np.int32)
            part[:nv] = i * width + np.sort(rng.choice(width, nv,
                                                       replace=False))
            parts.append(part)
            nvs.append(nv)
    caps = [p.shape[0] for p in parts]
    offs = np.cumsum([0, *caps[:-1]]).astype(np.int64)
    return (torch.from_numpy(np.concatenate(parts)).to(dev),
            torch.from_numpy(offs).to(dev),
            torch.from_numpy(np.asarray(nvs, np.int32)).to(dev))


def lookup_inputs(dev, seed: int):
    """(keys int32[LOOKUP_CAP], queries int32[LOOKUP_Q]) as described
    above, made on the card from ``seed``."""
    import torch
    from repro_torch.core.types import INVALID_VID
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 17)
    n_v = 1 << cs.SCALE
    head = torch.randperm(n_v, generator=gen, device=dev)[:LOOKUP_N]
    keys = torch.full((LOOKUP_CAP,), INVALID_VID, dtype=torch.int32,
                      device=dev)
    keys[:LOOKUP_N] = head.sort().values.int()
    pick = torch.randint(0, LOOKUP_N, (64,), generator=gen, device=dev)
    queries = torch.cat([torch.randint(0, n_v, (LOOKUP_Q - 64,),
                                       generator=gen, device=dev),
                         keys[pick].long()]).int()
    return keys, queries


def host_us(fn, n: int = 2000) -> float:
    """Host time of one call of ``fn`` in µs, over ``n`` calls ending in one
    synchronise (the device's work overlaps the host's)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def same(name, got, want):
    import torch
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{name} differs from plain at {bad} places")


def both_times(fn, kernel: str):
    """(ms by CUDA events a call, device ms a call by torch.profiler)."""
    return cs.time_ms(fn, iters=50), cs.device_ms(fn, kernel, iters=50)


def turns(name: str, old, new, kernel: str, smi: str, host: bool = False):
    """Time ``old`` (the parent) and ``new``, calls of no arguments, in
    turns: parent, new, new, parent; by events and device time, and by host
    µs a call where ``host``."""
    rows = []
    for who in ("parent", "new", "new", "parent"):
        fn = old if who == "parent" else new
        ms, dev_ms = both_times(fn, kernel)
        rows.append(f"{who} {ms:.4f} / {dev_ms:.4f}"
                    + (f" / {host_us(fn):.2f}" if host else ""))
    unit = "ms by events / device" + (" / host µs" if host else "")
    print(f"{name} turns ({unit}): {', '.join(rows)} [{smi}]")


def presence_section(dev, rng, smi, parent, o0, wrapper):
    import torch
    from repro_torch.kernels import presence as pm
    words, offs, masks, queries = cs.presence_inputs(dev, rng)
    r, b = offs.shape[0], queries.shape[0]
    want = pm.presence_matrix_ref(words, offs, masks, queries)
    same("presence_matrix", pm.presence_matrix_cuda(words, offs, masks,
                                                    queries), want)
    nbytes = words.numel() * 4 + r * 12 + b * 4 + r * b
    t_bound, by = cs.bound(nbytes, b * 20 + r * b * 4 * 6)
    print(f"presence_matrix: R={r} runs, {words.numel()} words, B={b} "
          f"queries; byte-equal to plain; bound {t_bound:.4f} ms ({by})")

    def kern(m=masks):
        return pm.presence_matrix_cuda(words, offs, m, queries)
    ms, dev_ms = both_times(kern, "presence")
    min_masks = torch.full_like(masks, 255)
    pms, pdev = both_times(lambda: kern(min_masks), "presence")
    print(f"presence_matrix (checkout): {ms:.4f} ms by events, {dev_ms:.4f} "
          f"ms device; {t_bound / dev_ms:.1%} of the bound by device time; "
          f"every row at FILTER_MIN_BITS {pms:.4f} / {pdev:.4f} [{smi}]")
    if o0 is not None:
        call = presence_call(o0)
        same("presence_matrix at -O0", call(words, offs, masks, queries),
             want)
        print(f"presence_matrix at -Xptxas -O0: byte-equal to plain; "
              f"{cs.time_ms(lambda: call(words, offs, masks, queries)):.4f}"
              f" ms by events [{smi}]")
    if parent is not None:
        old, how = ((wrapper.presence_matrix_cuda, "parent wrapper")
                    if wrapper is not None else
                    (presence_call(parent), "parent build called bare"))
        same("parent presence_matrix", old(words, offs, masks, queries), want)
        turns(f"presence_matrix ({how} against the checkout's wrapper)",
              lambda: old(words, offs, masks, queries), kern, "presence",
              smi)


def wrapper_split(keys, queries, smi):
    """The single-run wrapper's host cost and its parts, by the host clock
    (µs a call): what each step of a call costs on its own."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import lookup
    dev = queries.device
    n = LOOKUP_N
    n_t = torch.tensor([n], dtype=torch.int32, device=dev)
    fn = _build.bind("lookup", lookup._PROTOTYPES)[
        "batched_searchsorted_launch"]
    out = torch.empty(queries.shape, dtype=torch.int32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)

    def checks():
        _build.check_vector(keys, "keys", torch.int32, dev)
        _build.check_vector(queries, "queries", torch.int32, dev)

    parts = {
        "whole call, n_keys an int": lambda: lookup.batched_searchsorted_cuda(
            keys, queries, n),
        "whole call, n_keys on the card": lambda:
            lookup.batched_searchsorted_cuda(keys, queries, n_t),
        "int n_keys to the card": lambda: torch.tensor(
            [n], dtype=torch.int32, device=dev),
        "current_device": torch.cuda.current_device,
        "raw current stream": lambda: torch._C._cuda_getCurrentRawStream(
            dev.index),
        "device and type checks": checks,
        "torch.empty of the output": lambda: torch.empty(
            queries.shape, dtype=torch.int32, device=dev),
        "ctypes launch alone": lambda: fn(
            keys.data_ptr(), queries.data_ptr(), n_t.data_ptr(),
            out.data_ptr(), queries.shape[0], keys.shape[0], stream),
    }
    print("batched_searchsorted wrapper, host µs a call: " + "; ".join(
        f"{k} {host_us(f):.2f}" for k, f in parts.items()) + f" [{smi}]")


def lookup_section(dev, seed, smi, parent, o0, wrapper):
    import torch
    from repro_torch.kernels import lookup
    keys, queries = lookup_inputs(dev, seed)
    n_t = torch.tensor([LOOKUP_N], dtype=torch.int32, device=dev)
    want = lookup.batched_searchsorted_ref(keys, queries, LOOKUP_N)
    for nk in (LOOKUP_N, n_t):
        same("batched_searchsorted",
             lookup.batched_searchsorted_cuda(keys, queries, nk), want)
    t_bound, by = cs.bound(4 * LOOKUP_N + 8 * LOOKUP_Q + 4,
                           4 * LOOKUP_Q * LOOKUP_N.bit_length())
    head = keys[:LOOKUP_N]
    ms, dev_ms = both_times(
        lambda: lookup.batched_searchsorted_cuda(keys, queries, n_t),
        "searchsorted")
    lms, ldev = both_times(lambda: torch.searchsorted(head, queries),
                           "searchsorted")
    print(f"batched_searchsorted (checkout): n_keys={LOOKUP_N} (cap "
          f"{LOOKUP_CAP}), nq={LOOKUP_Q}; byte-equal to plain; {ms:.4f} ms "
          f"by events, {dev_ms:.4f} ms device; bound {t_bound:.5f} ms ({by});"
          f" torch.searchsorted {lms:.4f} / {ldev:.4f} [{smi}]")
    small = torch.tensor([2048], dtype=torch.int32, device=dev)
    equal = torch.full_like(queries, int(keys[LOOKUP_N // 3]))
    probes = {"n_keys 2048": (keys, queries, small),
              "every query equal": (keys, equal, n_t)}
    for name, args in probes.items():
        same(f"batched_searchsorted, {name}",
             lookup.batched_searchsorted_cuda(*args),
             lookup.batched_searchsorted_ref(*args))
    print("batched_searchsorted probes (ms by events / device): " + "; ".join(
        "{} {:.4f} / {:.4f}".format(name, *both_times(
            lambda a=args: lookup.batched_searchsorted_cuda(*a),
            "searchsorted")) for name, args in probes.items())
        + f" [{smi}]")
    wrapper_split(keys, queries, smi)
    if o0 is not None:
        call = lookup_call(o0)
        for args in [(keys, queries, n_t), *probes.values()]:
            same("batched_searchsorted at -O0", call(*args),
                 lookup.batched_searchsorted_ref(*args))
        print(f"batched_searchsorted at -Xptxas -O0: byte-equal to plain; "
              f"{cs.time_ms(lambda: call(keys, queries, n_t)):.4f} ms by "
              f"events [{smi}]")
    if parent is not None:
        # A bare build takes n_keys on the card only; a wrapper takes both.
        old, how = ((wrapper.batched_searchsorted_cuda, "parent wrapper")
                    if wrapper is not None else
                    (lookup_call(parent), "parent build called bare"))
        forms = {"n_keys on the card": n_t}
        if wrapper is not None:
            forms["n_keys an int"] = LOOKUP_N
        for form, nk in forms.items():
            same("parent batched_searchsorted", old(keys, queries, nk), want)
            turns(f"batched_searchsorted, {form} ({how} against the "
                  f"checkout's wrapper)", lambda: old(keys, queries, nk),
                  lambda: lookup.batched_searchsorted_cuda(keys, queries, nk),
                  "searchsorted", smi, host=True)


def runs_section(dev, rng, smi, parent, o0, wrapper):
    import torch
    from repro_torch.kernels import lookup
    keys, offs, nv = runs_inputs(rng, dev)
    _, queries = lookup_inputs(dev, 1)
    r, b = offs.shape[0], queries.shape[0]
    args = (keys, offs, nv, queries)
    want = lookup.batched_searchsorted_runs_ref(*args)
    same("batched_searchsorted_runs",
         lookup.batched_searchsorted_runs_cuda(*args), want)
    n_keys = int(nv.long().sum())
    t_bound, by = cs.bound(4 * n_keys + 4 * b + 12 * r + 4 * r * b,
                           4 * r * b * 12)
    # torch.searchsorted over the plain version's int64 keys, made unique
    # across runs, for every (run, query) pair at once: made outside the
    # timed call.
    slot = torch.arange(keys.shape[0], device=dev)
    run = torch.searchsorted(offs, slot, right=True) - 1
    k64 = torch.where(slot - offs[run] < nv.long()[run], keys.long(),
                      (1 << 31) - 1) + (1 << 31) | (run << 32)
    q64 = ((torch.arange(r, device=dev) << 32)[:, None]
           | (queries.long() + (1 << 31))).reshape(-1)
    ms, dev_ms = both_times(
        lambda: lookup.batched_searchsorted_runs_cuda(*args), "searchsorted")
    lms, ldev = both_times(lambda: torch.searchsorted(k64, q64),
                           "searchsorted")
    del k64, q64
    print(f"batched_searchsorted_runs: R={r} runs ({n_keys} keys in "
          f"{keys.shape[0]} slots) x B={b}; byte-equal to plain; {ms:.4f} ms"
          f" by events, {dev_ms:.4f} ms device; bound {t_bound:.4f} ms "
          f"({by}); torch.searchsorted over int64 (run, key) "
          f"{lms:.4f} / {ldev:.4f} [{smi}]")
    if o0 is not None:
        call = runs_call(o0)
        same("batched_searchsorted_runs at -O0", call(*args), want)
        print(f"batched_searchsorted_runs at -Xptxas -O0: byte-equal to "
              f"plain; {cs.time_ms(lambda: call(*args)):.4f} ms by events "
              f"[{smi}]")
    old = (getattr(wrapper, "batched_searchsorted_runs_cuda", None)
           or (runs_call(parent) if parent is not None else None))
    if old is not None:
        same("parent batched_searchsorted_runs", old(*args), want)
        turns("batched_searchsorted_runs", lambda: old(*args),
              lambda: lookup.batched_searchsorted_runs_cuda(*args),
              "searchsorted", smi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent-presence", type=Path, default=None,
                    help="an earlier presence.cu to time in turns")
    ap.add_argument("--parent-lookup", type=Path, default=None,
                    help="an earlier lookup.cu to time in turns")
    ap.add_argument("--parent-wrappers", type=Path, default=None,
                    help="a directory of the earlier presence.py and "
                    "lookup.py wrappers, timed with the earlier sources")
    ap.add_argument("--o0", action="store_true",
                    help="also build the checkout's sources at -Xptxas -O0")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_bench: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops  # noqa: F401  (store first)
    smi = cs.smi_line()
    print(f"card: {smi}")
    _build.build_all(["presence", "lookup"])
    for name in ("presence", "lookup"):
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "bytes smem" in line:
                print(f"  ptxas ({name}): {line.strip()}")
    libs = {}
    for name, path in (("presence", args.parent_presence),
                       ("lookup", args.parent_lookup)):
        parent = None if path is None else nvcc_build(path, f"{name}_parent")
        libs[f"parent_{name}"] = parent
        libs[f"wrapper_{name}"] = (
            parent_wrapper(args.parent_wrappers / f"{name}.py", parent)
            if parent is not None and args.parent_wrappers is not None
            else None)
        libs[f"o0_{name}"] = (nvcc_build(_build.CSRC / f"{name}.cu",
                                         f"{name}_o0", ("-Xptxas", "-O0"))
                              if args.o0 else None)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    presence_section(dev, rng, smi, libs["parent_presence"],
                     libs["o0_presence"], libs["wrapper_presence"])
    lookup_section(dev, args.seed, smi, libs["parent_lookup"],
                   libs["o0_lookup"], libs["wrapper_lookup"])
    runs_section(dev, rng, smi, libs["parent_lookup"], libs["o0_lookup"],
                 libs["wrapper_lookup"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
