"""Immutable on-disk CSR segment files (paper Fig. 6 layout).

The port of ``repro.storage.segments``: the same bytes, written from and
read back into the port's tensors.  A run's valid prefixes are copied to
the host in ONE device-to-host copy (the body is their concatenation), and
a segment's body goes to the store's device in one upload.

A segment serializes one ``CSRRunArrays`` + its ``RunFile`` header metadata:
a fixed 64-byte header, a topology section (vkeys/voff/dst/ts/marker) and a
property section (prop) — the paper's CSR file + property file packed into
one file so ``os.replace`` publishes both atomically.  Only valid prefixes
are stored; load re-pads to quantized capacities, so a round trip is exact
on the valid region.  See the package docstring for the byte-level spec.

Format v2 appends a CRC'd VERTEX-PRESENCE FILTER section after the body:
a 16-byte section header (magic ``FLT1``, section CRC, mbits, word count)
followed by the packed ``uint32`` filter words (``core.filters``).  The
filter is a pure deterministic function of the body's vkey set, so a
segment rebuilt from its WAL generation regenerates a byte-identical
section.  Reads stay backward compatible: v1 files (no section) load
unchanged and simply report "no filter"; the body CRC never covers the
section, so v1 readers that tolerate trailing bytes also keep working.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core import csr, filters
from ..core.types import (CSRRunArrays, RunFile, resolve_device,
                          scalar)
from . import faultfs
from .errors import CorruptionError, TransientIOError
from .fsutil import fsync_dir as _fsync_dir

# Cold-read feeder for the amplification ledger (process-wide: segment
# files are read by loaders, recovery, and the scrubber — no store label).
_OBS_SEG_READ_BYTES = obs.counter("storage_segment_read_bytes")

MAGIC = b"LSMGSEG1"
FORMAT_VERSION = 2
#: Versions this reader accepts (v1 = pre-filter files from older stores).
SUPPORTED_VERSIONS = (1, 2)
_HDR = struct.Struct("<8sIIIiqqqqII")  # 64 bytes
assert _HDR.size == 64

_FLT_MAGIC = b"FLT1"
_FHDR = struct.Struct("<4sIII")  # magic, section crc, mbits, n words
assert _FHDR.size == 16


_I32 = torch.int32


def _host_body(a: CSRRunArrays, nv: int, ne: int) -> bytes:
    """The segment body: the run's valid prefixes as little-endian bytes
    in file order (vkeys, voff, dst, ts, marker, prop), concatenated on
    the run's device and copied to the host once."""
    parts = (a.vkeys[:nv], a.voff[:nv + 1], a.dst[:ne], a.ts[:ne],
             a.marker[:ne], a.prop[:ne])
    return torch.cat([p.contiguous().view(torch.uint8)
                      for p in parts]).cpu().numpy().tobytes()


def advise_willneed(path: str) -> None:
    """Ask the kernel to start readahead of a segment file (best effort).

    The read path's background prefetcher calls this before the mmap load:
    ``POSIX_FADV_WILLNEED`` turns the subsequent ``read_segment`` page-ins
    into sequential readahead instead of on-demand faults, so a cold load
    overlaps even more of the foreground device dispatch."""
    if not hasattr(os, "posix_fadvise"):  # non-POSIX: page cache still wins
        return
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # racing an unlink: the loader's own open reports it
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_WILLNEED)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_segment(path: str, rf: RunFile, *,
                  version: int = FORMAT_VERSION) -> int:
    """Serialize ``rf`` to ``path`` (tmp file + fsync + atomic replace +
    dir fsync).  Returns bytes written.

    ``version`` defaults to the current format; pass 1 to emit a legacy
    pre-filter file (tests exercise the backward-compat read path with
    it).  The v2 filter section is computed HERE from the body's vkeys —
    never taken from ``rf.presence`` — so a WAL rebuild of the same run
    (``scrub.rebuild_segment_from_wal``) regenerates the section
    byte-identically."""
    if version not in SUPPORTED_VERSIONS:
        raise ValueError(f"segment version {version} not in "
                         f"{SUPPORTED_VERSIONS}")
    nv, ne = rf.nv, rf.ne
    body = _host_body(rf.arrays, nv, ne)
    hdr = _pack_header(rf, zlib.crc32(body), version)
    sect = b""
    if version >= 2:
        words = filters.build_words(
            np.frombuffer(body, "<i4", nv).astype(np.int64))
        sect = _pack_filter_section(words)
    tmp = path + ".tmp"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        _write_all(fd, hdr, path)
        _write_all(fd, body, path)
        if sect:
            _write_all(fd, sect, path)
        faultfs.fsync(fd, path)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))
    return len(hdr) + len(body) + len(sect)


def _write_all(fd: int, data: bytes, path: str) -> None:
    view = memoryview(data)
    while view:
        view = view[faultfs.write(fd, view, path):]


def _pack_header(rf: RunFile, body_crc: int,
                 version: int = FORMAT_VERSION) -> bytes:
    raw = _HDR.pack(MAGIC, version, 0, body_crc, rf.level, rf.fid,
                    rf.min_vid, rf.max_vid, rf.created_ts, rf.nv, rf.ne)
    hcrc = zlib.crc32(raw)
    return _HDR.pack(MAGIC, version, hcrc, body_crc, rf.level, rf.fid,
                     rf.min_vid, rf.max_vid, rf.created_ts, rf.nv, rf.ne)


def _pack_filter_section(words: np.ndarray) -> bytes:
    """Filter section bytes: 16-byte header + packed uint32 words.  The
    section CRC covers mbits + nwords + payload, so a flipped shape field
    is caught even when the payload bytes survive."""
    payload = np.asarray(words, np.uint32).astype("<u4").tobytes()
    nwords = len(words)
    mbits = nwords * 32
    fcrc = zlib.crc32(struct.pack("<II", mbits, nwords) + payload)
    return _FHDR.pack(_FLT_MAGIC, fcrc, mbits, nwords) + payload


def read_segment_header(path: str) -> dict:
    """Parse + CRC-check the 64-byte header only (cheap metadata peek).

    Failure typing: medium errors (EIO, mmap fault) raise
    ``TransientIOError`` (retryable); wrong bytes (bad magic/CRC/version,
    truncation, missing live file) raise ``CorruptionError`` (never
    retryable — re-reading rot yields rot)."""
    try:
        faultfs.check_read(path)
        with open(path, "rb") as f:
            raw = f.read(_HDR.size)
    except FileNotFoundError as e:
        raise CorruptionError(f"segment {path}: live file missing") from e
    except OSError as e:
        raise TransientIOError(
            e.errno or 5, f"segment {path}: header read failed") from e
    if len(raw) != _HDR.size:
        raise CorruptionError(f"segment {path}: truncated header")
    (magic, ver, hcrc, body_crc, level, fid, min_vid, max_vid,
     created_ts, nv, ne) = _HDR.unpack(raw)
    if magic != MAGIC:
        raise CorruptionError(f"segment {path}: bad magic")
    if ver not in SUPPORTED_VERSIONS:
        raise CorruptionError(f"segment {path}: unsupported version {ver}")
    zeroed = _HDR.pack(magic, ver, 0, body_crc, level, fid, min_vid,
                       max_vid, created_ts, nv, ne)
    if zlib.crc32(zeroed) != hcrc:
        raise CorruptionError(f"segment {path}: header CRC mismatch")
    return dict(fid=fid, level=level, min_vid=min_vid, max_vid=max_vid,
                created_ts=created_ts, nv=nv, ne=ne, body_crc=body_crc,
                ver=ver)


def body_nbytes(nv: int, ne: int) -> int:
    """Exact body size for a segment with ``nv`` vertices / ``ne`` edges."""
    return 4 * (nv + (nv + 1) + ne + ne) + ne + 4 * ne


def verify_segment(path: str) -> dict:
    """CRC-verify header + body — and, for v2 files, the filter section —
    without materializing run arrays (the scrubber's cheap integrity
    pass).  Returns the header meta; raises ``CorruptionError`` /
    ``TransientIOError`` like ``read_segment``."""
    meta = read_segment_header(path)
    nv, ne = meta["nv"], meta["ne"]
    try:
        mm = np.memmap(path, dtype=np.uint8, mode="r", offset=_HDR.size)
    except FileNotFoundError as e:
        raise CorruptionError(f"segment {path}: live file missing",
                              fid=meta["fid"]) from e
    except OSError as e:
        raise TransientIOError(
            e.errno or 5, f"segment {path}: body mmap failed") from e
    need = body_nbytes(nv, ne)
    if mm.shape[0] < need:
        raise CorruptionError(f"segment {path}: truncated body",
                              fid=meta["fid"])
    if zlib.crc32(mm[:need]) != meta["body_crc"]:
        raise CorruptionError(f"segment {path}: body CRC mismatch",
                              fid=meta["fid"])
    if meta["ver"] >= 2:
        _read_filter_words(path, meta)   # raises on a rotten section
    return meta


def _read_filter_words(path: str, meta: dict) -> np.ndarray:
    """Read + CRC-check a v2 file's filter section; returns the uint32
    words.  Only called for ``meta['ver'] >= 2`` — a missing or short
    section there is corruption, not a legacy file."""
    off = _HDR.size + body_nbytes(meta["nv"], meta["ne"])
    try:
        faultfs.check_read(path)
        with open(path, "rb") as f:
            f.seek(off)
            raw = f.read(_FHDR.size)
            if len(raw) != _FHDR.size:
                raise CorruptionError(
                    f"segment {path}: truncated filter section",
                    fid=meta["fid"])
            fmagic, fcrc, mbits, nwords = _FHDR.unpack(raw)
            if fmagic != _FLT_MAGIC:
                raise CorruptionError(
                    f"segment {path}: bad filter magic", fid=meta["fid"])
            payload = f.read(nwords * 4)
    except FileNotFoundError as e:
        raise CorruptionError(f"segment {path}: live file missing",
                              fid=meta["fid"]) from e
    except OSError as e:
        raise TransientIOError(
            e.errno or 5, f"segment {path}: filter read failed") from e
    if len(payload) != nwords * 4:
        raise CorruptionError(f"segment {path}: truncated filter payload",
                              fid=meta["fid"])
    if zlib.crc32(struct.pack("<II", mbits, nwords) + payload) != fcrc:
        raise CorruptionError(f"segment {path}: filter CRC mismatch",
                              fid=meta["fid"])
    if mbits != nwords * 32 or (mbits & (mbits - 1)):
        raise CorruptionError(f"segment {path}: bad filter shape",
                              fid=meta["fid"])
    _OBS_SEG_READ_BYTES.inc(_FHDR.size + len(payload))
    return np.frombuffer(payload, "<u4").astype(np.uint32)


def read_segment_filter(path: str) -> Optional[filters.PresenceFilter]:
    """Load just the presence filter of a segment (header + 16-byte
    section header + packed words — no body read, so rehydrating every
    shard's filters on recovery stays cheap).  Returns ``None`` for v1
    files: legacy segments have no filter and read as "always maybe"."""
    meta = read_segment_header(path)
    if meta["ver"] < 2:
        return None
    words = _read_filter_words(path, meta)
    return filters.from_words(words, len(words) * 32)


def read_segment(path: str, *, device=None, verify: bool = True
                 ) -> Tuple[dict, CSRRunArrays]:
    """Load a segment: (header meta, CSRRunArrays at quantized capacities)
    on ``device`` (None: the current CUDA card, as ``resolve_device``).

    The body is mmap'd (``np.memmap``) so cold loads stream through the OS
    page cache, CRC-checked in place, copied once into writable host
    memory (a read-only mapping cannot back a tensor) and uploaded to the
    device in one copy, where the columns are split out of it."""
    dev = resolve_device(device)
    meta = read_segment_header(path)
    nv, ne = meta["nv"], meta["ne"]
    try:
        mm = np.memmap(path, dtype=np.uint8, mode="r", offset=_HDR.size)
    except FileNotFoundError as e:
        raise CorruptionError(f"segment {path}: live file missing",
                              fid=meta["fid"]) from e
    except OSError as e:
        raise TransientIOError(
            e.errno or 5, f"segment {path}: body mmap failed") from e
    need = body_nbytes(nv, ne)
    if mm.shape[0] < need:
        raise CorruptionError(f"segment {path}: truncated body",
                              fid=meta["fid"])
    _OBS_SEG_READ_BYTES.inc(_HDR.size + need)
    # crc32 accepts the buffer protocol: no .tobytes() copy of the whole
    # mmapped body — cold loads stay page-cache-streamed.
    if verify and zlib.crc32(mm[:need]) != meta["body_crc"]:
        raise CorruptionError(f"segment {path}: body CRC mismatch",
                              fid=meta["fid"])
    body = torch.from_numpy(np.array(mm[:need])).to(dev)
    del mm
    ends = np.cumsum([0, 4 * nv, 4 * (nv + 1), 4 * ne, 4 * ne, ne, 4 * ne])
    col = [body[int(lo):int(hi)] for lo, hi in zip(ends[:-1], ends[1:])]
    # prop follows the one-byte markers: a view of it needs a 4-byte
    # aligned start, so it is copied out when ne is not a multiple of 4.
    prop = col[5] if ends[5] % 4 == 0 else col[5].clone()
    run = CSRRunArrays(
        vkeys=col[0].view(_I32), voff=col[1].view(_I32),
        dst=col[2].view(_I32), ts=col[3].view(_I32), marker=col[4] != 0,
        prop=prop.view(torch.float32), nv=scalar(nv, dev),
        ne=scalar(ne, dev))
    vcap = csr.quantize_cap(max(nv, 1))
    ecap = csr.quantize_cap(max(ne, 1))
    return meta, csr.repad_run(run, vcap, ecap)
