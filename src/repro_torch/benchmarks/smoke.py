"""Benchmark bit-rot gate: tiny-scale run of every registered suite (the
port of ``benchmarks/smoke.py``).

``python -m repro_torch.benchmarks.smoke [--device cpu]`` runs each suite
from ``repro_torch.benchmarks.run.suites()`` at smoke scale (numbers are
meaningless at this scale), captures its CSV rows, and validates the
harness contract: every row is ``name,us_per_call,derived`` with a finite
non-negative cost.  The gate prints one JSON report and exits non-zero if
any suite raises, emits no rows, or emits a malformed row.  The smoke scale
is picked when ``main`` runs (``common.use_scale``), not by setting the
environment at import.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import re
import sys
import time
import traceback

from .common import Scale, cli_device, use_scale

_ROW = re.compile(r"^(?P<name>[\w./\-]+),(?P<us>-?[\d.eE+\-]+),(?P<derived>.*)$")


def _check_rows(lines: list) -> list:
    """Return a list of per-row error strings (empty = schema holds)."""
    errors = []
    for line in lines:
        m = _ROW.match(line)
        if not m:
            errors.append(f"malformed row: {line!r}")
            continue
        try:
            us = float(m.group("us"))
        except ValueError:
            errors.append(f"non-numeric cost: {line!r}")
            continue
        if not math.isfinite(us) or us < 0:
            errors.append(f"non-finite/negative cost: {line!r}")
    return errors


def run_suites(device=None) -> dict:
    """Every suite at smoke scale: the report, with each suite's rows."""
    from .run import suites
    report = {"mode": "smoke", "suites": [], "failures": 0}
    with use_scale(Scale(smoke=True)):
        for label, fn in suites():
            entry = {"suite": label, "ok": True, "rows": 0, "seconds": 0.0}
            buf = io.StringIO()
            t0 = time.time()
            try:
                with contextlib.redirect_stdout(buf):
                    fn(device)
            except Exception:
                entry["ok"] = False
                entry["error"] = traceback.format_exc(limit=4)
            entry["seconds"] = round(time.time() - t0, 2)
            lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
            entry["rows"] = len(lines)
            entry["lines"] = lines
            if entry["ok"]:
                errors = _check_rows(lines)
                if not lines:
                    errors.append("suite emitted no rows")
                if errors:
                    entry["ok"] = False
                    entry["error"] = "; ".join(errors[:5])
            if not entry["ok"]:
                report["failures"] += 1
            report["suites"].append(entry)
    return report


def main(argv=None) -> None:
    report = run_suites(cli_device(argv))
    for entry in report["suites"]:
        del entry["lines"]
    print(json.dumps(report, indent=2))
    sys.exit(1 if report["failures"] else 0)


if __name__ == "__main__":
    main()
