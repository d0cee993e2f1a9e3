"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``.
Libraries are built at first use from the sources in the checkout, into
``build/repro_torch/`` at the repository root (git-ignored), and named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.  ``build_all`` starts one ``nvcc`` per source, all
at once, and waits for every one of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
SOURCES = ("presence", "merge_perm", "segment_reduce", "lookup",
           "flash_attention", "hash_claim")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LAUNCH_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_BOUND: Dict[str, Dict[str, object]] = {}
#: ptxas register/shared-memory report of each build made by this process.
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils import cpp_extension
    home = os.environ.get("CUDA_HOME") or cpp_extension.CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no library yet, all in parallel.
    Returns the seconds each build took (0.0 for a library reused)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    took: Dict[str, float] = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            took[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                path = library_path(name)
                if not path.exists():
                    build_all([name])
                lib = ctypes.CDLL(str(path))
                _LIBS[name] = lib
    return lib


def bind_library(lib: ctypes.CDLL,
                 prototypes: Dict[str, list]) -> Dict[str, object]:
    """The entry points of a loaded library by name, each with its ctypes
    argument types from ``prototypes``; every entry point returns an int."""
    fns = {}
    for entry, argtypes in prototypes.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[entry] = fn
    return fns


def bind(name: str, prototypes: Dict[str, list]) -> Dict[str, object]:
    """The C entry points of ``csrc/<name>.cu`` by name, bound by
    ``bind_library`` once, when the library is first bound, and not on
    every call."""
    fns = _BOUND.get(name)
    if fns is None:
        fns = _BOUND[name] = bind_library(load(name), prototypes)
    return fns


def run_on(dev, fn, *args) -> int:
    """Call the C entry point ``fn(*args, stream)`` with the handle of
    ``dev``'s current stream, ``dev`` being the current device: a kernel
    launches on the current device.  The device is switched only when
    another one is current.  The handle comes from the raw getter that
    PyTorch's own generated code uses (``torch.cuda.current_stream``
    builds a Stream object: about 5 µs a call on the H100's host)."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def count_launch(fn, path=None) -> None:
    """Add one to the launch count of the kernel wrapper ``fn`` (and to
    ``fn.path_launches[path]`` when a path is named), under one lock: the
    sharded read launches from several pool threads at once, and a bare
    ``+= 1`` there could lose a launch."""
    with _LAUNCH_LOCK:
        fn.launches += 1
        if path is not None:
            fn.path_launches[path] += 1


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def check_vector(t, name: str, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous 1-D tensor of ``dtype`` on
    ``device``: what a kernel's raw pointer needs."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")
