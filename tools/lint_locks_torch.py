#!/usr/bin/env python
"""AST lint of the PyTorch port's lock discipline.

The two rules of ``tools/lint_locks.py`` (no device work under the commit
lock; the read path takes no writer lock), applied to the port's store and
its concurrent wrapper.  Device work in the port is a call through
``torch`` or through the port's own device-work aliases, so those roots are
added to the JAX package's ``DEVICE_ROOTS``; the port's extra spine
helpers, the prefetch pool and the wrapper's ``snapshot`` join the read
path.  ``tools/lint_locks.py`` itself, its targets and its rules for the
JAX package stay as they are: this script loads its own copy of that
module and widens the copy's sets.

    python tools/lint_locks_torch.py [files...]

Exits 1 with file:line diagnostics on any violation.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_spec = importlib.util.spec_from_file_location(
    "lint_locks_port_rules", Path(__file__).resolve().with_name(
        "lint_locks.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)

# Calls whose root dispatches device work in the port: torch itself, and
# the port's helpers that make or fill device tensors (``mg_mod``, ``csr``,
# ``mlindex`` and ``kops`` are already in the JAX package's set).
PORT_DEVICE_ROOTS = {"torch", "to_device", "scalar", "_pad_backbone",
                     "_fit_spine_cols", "_stack_presence", "_empty_cols"}
PORT_READ_PATH_FUNCS = {"_filter_remap_spine", "_stack_presence",
                        "_pad_backbone", "_empty_cols", "prefetch_pool"}
PORT_READ_PATH_METHODS = {("ConcurrentLSMGraph", "snapshot"),
                          ("LSMGraph", "query_edge"),
                          ("LSMGraph", "query_edges_batch")}

base.DEVICE_ROOTS = base.DEVICE_ROOTS | PORT_DEVICE_ROOTS
base.READ_PATH_FUNCS = base.READ_PATH_FUNCS | PORT_READ_PATH_FUNCS
base.READ_PATH_METHODS = base.READ_PATH_METHODS | PORT_READ_PATH_METHODS
base.DEFAULT_TARGETS = [
    str(REPO / "src" / "repro_torch" / "core" / "store.py"),
    str(REPO / "src" / "repro_torch" / "core" / "concurrent.py")]

DEFAULT_TARGETS = base.DEFAULT_TARGETS
lint_source = base.lint_source
main = base.main


if __name__ == "__main__":
    sys.exit(main())
