"""Sharded, atomic, async-capable checkpoints (the restart half of fault
tolerance); the port of ``repro.checkpoint.manager``.

Layout per step, as the reference writes it:
    <dir>/step_<N>.tmp/...   (written)
    <dir>/step_<N>/          (atomic rename = commit)
        manifest.json        — leaf keys, shapes, dtypes, step metadata
        shard_<k>.npz        — the leaves whose sorted index is k mod shards

A state is a tree of dicts, lists, tuples and NamedTuples over leaves:
NumPy arrays or scalars, torch tensors, or an ``nn.Module`` (a ``Model``),
which flattens by parameter name.  Leaf keys are the reference's
(``_fmt``: a dict key or list index as it is, a NamedTuple field as
``.name``, joined by ``/``; a parameter ``blocks.0.attn.wq.w`` as
``blocks/0/attn/wq/w``), so for the reference's own states (NumPy leaves
in dicts, lists and tuples) the manifest and every shard are byte-equal
to what it writes.

bfloat16.  The reference saves a bfloat16 leaf's 16 raw bits under the
descriptor ``<V2`` and records ``"dtype": "bfloat16"`` in the manifest,
but its ``restore`` returns the raw ``|V2`` void array: a bfloat16 state
cannot be restored there (ROADMAP, the reference's fault 9).  The port
writes the same bytes and rebuilds bfloat16 from the manifest on restore,
from its own directories and from the reference's.

``restore`` loads into the template: a tensor or a module's parameters in
place, on their device; a NumPy leaf is replaced by the loaded array (a
bfloat16 one by a bfloat16 CPU tensor, since NumPy has no bfloat16).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

_SEP = "/"
_BF16_DESCR = "<V2"   # the descriptor NumPy writes for a bfloat16 array


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree, path: Tuple[str, ...] = ()):
    """(key parts, leaf) in the reference's flatten order (dict keys
    sorted); a module's parameters in their own order."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield path + tuple(name.split(".")), p
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), path + (f".{f}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:   # None is an empty subtree, as in JAX
        yield path, tree


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as (host array, manifest dtype).  A bfloat16 leaf is its 16
    raw bits as int16; a tensor is copied, so the caller may go on
    writing it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16), "bfloat16"
    return a, str(a.dtype)


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {_SEP.join(path): _to_host(leaf) for path, leaf in _leaves(tree)}


def _savez(path: str, payload: Dict[str, Tuple[np.ndarray, str]]) -> None:
    """``np.savez(path, **arrays)`` as NumPy writes it, with bfloat16
    arrays under the ``<V2`` descriptor ``np.savez`` gives them."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zipf:
        for key, (arr, dtype) in payload.items():
            with zipf.open(key + ".npy", "w", force_zip64=True) as fid:
                if dtype != "bfloat16":
                    np.lib.format.write_array(fid, np.asanyarray(arr))
                    continue
                np.lib.format.write_array_header_1_0(
                    fid, {"descr": _BF16_DESCR, "fortran_order": False,
                          "shape": arr.shape})
                fid.write(np.ascontiguousarray(arr).tobytes())


def _from_host(arr: np.ndarray, dtype: str):
    """A loaded array as its manifest dtype: bfloat16 (raw ``|V2`` or
    int16 bits) as a bfloat16 CPU tensor; anything else as it is."""
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return arr


def _load_into(template, arr):
    if not isinstance(arr, torch.Tensor):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    if arr.dtype != template.dtype:
        raise TypeError(f"checkpoint leaf is {arr.dtype}, the template's "
                        f"{template.dtype}")
    with torch.no_grad():
        template.copy_(arr.reshape(template.shape))
    return template


def _unflatten(template, blobs, path: Tuple[str, ...] = ()):
    if isinstance(template, nn.Module):
        for name, p in template.named_parameters():
            _load_into(p, blobs[_SEP.join(path + tuple(name.split(".")))])
        return template
    if isinstance(template, dict):
        return {k: _unflatten(template[k], blobs, path + (str(k),))
                for k in sorted(template)}
    if _is_namedtuple(template):
        return type(template)(*(
            _unflatten(getattr(template, f), blobs, path + (f".{f}",))
            for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, blobs, path + (str(i),))
                              for i, v in enumerate(template))
    if template is None:
        return None
    arr = blobs[_SEP.join(path)]
    if isinstance(template, torch.Tensor):
        return _load_into(template, arr)
    return arr


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None,
             shards: int = 4) -> str:
        return self._write(step, _flatten(state), extra, shards)

    def _write(self, step: int, flat: Dict[str, Tuple[np.ndarray, str]],
               extra: Optional[Dict[str, Any]] = None,
               shards: int = 4) -> str:
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        keys = sorted(flat)
        manifest = {
            "step": step,
            "extra": extra or {},
            "leaves": {k: {"shape": list(flat[k][0].shape),
                           "dtype": flat[k][1],
                           "shard": i % shards}
                       for i, k in enumerate(keys)},
            "n_shards": shards,
        }
        for s in range(shards):
            _savez(os.path.join(tmp, f"shard_{s}.npz"),
                   {k.replace(_SEP, "__"): flat[k]
                    for i, k in enumerate(keys) if i % shards == s})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic commit
        self._gc()
        return final

    def save_async(self, step: int, state, **kw) -> None:
        """The device-to-host copy happens here (a consistent snapshot);
        the file I/O overlaps with the next step on a thread."""
        flat_host = _flatten(state)
        self.wait()
        self._async_thread = threading.Thread(
            target=self._write, args=(step, flat_host), kwargs=kw,
            daemon=True)
        self._async_thread.start()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return max(steps) if steps else None

    def restore(self, template, step: Optional[int] = None):
        """-> (state, extra).  ``template`` supplies the tree structure and,
        for tensors and modules, the tensors loaded into."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_meta = manifest["leaves"]
        blobs: Dict[str, Any] = {}
        for s in range(manifest["n_shards"]):
            with np.load(os.path.join(path, f"shard_{s}.npz")) as z:
                for k in z.files:
                    key = k.replace("__", _SEP)
                    arr = z[k]
                    want = leaves_meta[key]
                    if list(arr.shape) != want["shape"]:
                        raise ValueError(f"{key}: shape {arr.shape}, "
                                         f"manifest {want['shape']}")
                    blobs[key] = _from_host(arr, want["dtype"])
        missing = [_SEP.join(p) for p, _ in _leaves(template)
                   if _SEP.join(p) not in blobs]
        if missing:
            raise KeyError(f"checkpoint step {step} lacks {missing[:5]}")
        return _unflatten(template, blobs), manifest["extra"]

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
