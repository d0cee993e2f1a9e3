#!/usr/bin/env python
"""AST lint of the PyTorch port's lock discipline.

The two rules of ``tools/lint_locks.py`` (no device work under the commit
lock; the read path takes no writer lock), applied to the port's store, its
concurrent wrapper, and its sharded store and compaction scheduler.  Device
work in the port is a call through ``torch`` or through the port's own
device-work aliases, so those roots are added to the JAX package's
``DEVICE_ROOTS``; the port's extra spine helpers, the prefetch pool and the
wrapper's ``snapshot`` join the read path.  In the sharded store, rule 1
also covers the coordinator's epoch and health locks (no device call in
their bodies: the epoch lock is held across the fan-out of per-shard
applies by design, the tau-epoch protocol, and those run in the shards' own
code on pool threads), and rule 2 the ``ShardedSnapshot`` (a sharded read
never touches the epoch lock).  ``tools/lint_locks.py`` itself, its targets
and its rules for the JAX package stay as they are: this script loads its
own copy of that module and widens the copy's sets.

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
                        "_pad_backbone", "_empty_cols", "prefetch_pool",
                        "lay_out_runs"}
PORT_READ_PATH_METHODS = {("ConcurrentLSMGraph", "snapshot"),
                          ("LSMGraph", "query_edge"),
                          ("LSMGraph", "query_edges_batch")}

# Locks whose bodies may hold no device call (rule 1): the store's commit
# lock, and the sharded store's epoch and health locks.
PORT_COMMIT_LOCKS = {"_lock", "_epoch_lock", "_health_lock"}


def _is_commit_lock(expr) -> bool:
    return (isinstance(expr, base.ast.Attribute)
            and expr.attr in PORT_COMMIT_LOCKS
            and isinstance(expr.value, base.ast.Name)
            and expr.value.id == "self")


base._is_self_lock = _is_commit_lock
base.DEVICE_ROOTS = base.DEVICE_ROOTS | PORT_DEVICE_ROOTS
base.WRITER_LOCKS = base.WRITER_LOCKS | {"_epoch_lock"}
base.READ_PATH_CLASSES = base.READ_PATH_CLASSES | {"ShardedSnapshot"}
base.READ_PATH_FUNCS = base.READ_PATH_FUNCS | PORT_READ_PATH_FUNCS
base.READ_PATH_METHODS = base.READ_PATH_METHODS | PORT_READ_PATH_METHODS
_PORT = REPO / "src" / "repro_torch"
base.DEFAULT_TARGETS = [
    str(_PORT / "core" / "store.py"), str(_PORT / "core" / "concurrent.py"),
    str(_PORT / "shard" / "store.py"), str(_PORT / "shard" / "scheduler.py")]

DEFAULT_TARGETS = base.DEFAULT_TARGETS
lint_source = base.lint_source
main = base.main


if __name__ == "__main__":
    sys.exit(main())
