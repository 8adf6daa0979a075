"""CRC-framed single-block files — the part of
deeplearning4j_tpu/serving/durable.py that the KV tiers' disk store
needs (`write_block_file` :440, `read_block_file` :456). The append-only
log broker and its consumer cursors wait for ROADMAP A8.

One evicted prefix block is persisted per file with the log's frame
discipline: a header of (magic, payload length, CRC32 of the payload),
then the payload, written to a temporary file, fsynced and renamed into
place. A process killed mid-spill leaves either no file (the temporary
was never renamed) or a complete frame, so a torn or corrupt file reads
as a cache miss, never as wrong bytes fed back into attention. The frame
is byte-for-byte the JAX package's: a file either package writes, the
other reads.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

__all__ = ["write_block_file", "read_block_file", "MAX_FRAME"]

_MAGIC = 0xD14A
_HDR = struct.Struct("<HII")  # magic, payload_len, crc32(payload)
#: the bound on one frame's payload (JAX durable.py:38): a header that
#: claims more is garbage
MAX_FRAME = 64 * 1024 * 1024


def write_block_file(path: str, payload: bytes) -> None:
    """Atomically persist one opaque payload as a CRC-framed file
    (temporary file, fsync, rename)."""
    if len(payload) > MAX_FRAME:
        raise ValueError(f"block payload {len(payload)} exceeds "
                         f"MAX_FRAME {MAX_FRAME}")
    hdr = _HDR.pack(_MAGIC, len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(hdr)
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_block_file(path: str) -> Optional[bytes]:
    """Read one CRC-framed block file. Returns None (a miss) on any
    defect: a missing file, a short header, a wrong magic, a truncated
    payload or a CRC mismatch."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    if len(raw) < _HDR.size:
        return None
    magic, length, crc = _HDR.unpack_from(raw, 0)
    if magic != _MAGIC or length > MAX_FRAME:
        return None
    payload = raw[_HDR.size:_HDR.size + length]
    if len(payload) != length or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        return None
    return payload
