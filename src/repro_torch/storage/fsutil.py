"""Tiny filesystem helpers shared by the durability modules."""
from __future__ import annotations

import os

from . import faultfs


def fsync_dir(dirname: str) -> None:
    """Fsync a directory so a just-created/renamed/unlinked entry survives
    power loss (fsync'd file *contents* don't imply a durable directory
    entry — the LevelDB-lineage rule).  Failures PROPAGATE: silently
    reporting a durable entry that isn't risks a manifest referencing a
    segment whose directory entry vanished — an unrecoverable store."""
    fd = os.open(dirname or ".", os.O_RDONLY)
    try:
        faultfs.fsync(fd, dirname or ".")
    finally:
        os.close(fd)
