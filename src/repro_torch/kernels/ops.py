"""Public entry points of the port's kernels.

Dispatch is by the device of the input tensors, never by what the machine
has: a CUDA tensor goes to the hand-written kernel (or the call raises), a
CPU tensor goes to the kernel's plain PyTorch version.  There is no
fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Dict

from .merge import (lex_searchsorted, merge_perm, merge_perm_cuda,
                    merge_streams, tournament_merge)
from .presence import presence_matrix, presence_matrix_cuda

#: Every kernel wrapper of the port, by kernel name.
KERNELS = {"presence_matrix": presence_matrix_cuda,
           "merge_perm": merge_perm_cuda}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last ``reset_launches`` (plain-version
    calls on CPU tensors are not launches)."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["presence_matrix", "merge_perm", "merge_streams",
           "tournament_merge", "lex_searchsorted", "launch_counts",
           "reset_launches", "KERNELS"]
