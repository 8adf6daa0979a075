"""Durable streaming transport — a port of
deeplearning4j_tpu/serving/durable.py: an embedded append-only log broker
with resumable consumer cursors and at-least-once delivery, and the
CRC-framed single-block files of the KV tiers' disk store.

A log is a file of length-prefixed CRC32-checked frames (magic, payload
length, CRC of the payload, then the JSON payload). A torn tail frame (a
producer killed mid-append) is not delivered until it completes, and a
restarting producer truncates it before appending. Consumers persist
their cursor atomically (temporary file, fsync, rename) only after the
batch was processed, so a consumer killed mid-batch re-reads that batch
on restart: at-least-once, never lossy. `DurableLogConsumer.commit_through`
commits per record, which the fleet router's request journal
(`serving/router.py`) relies on.

The frames are byte-for-byte the JAX package's: a log or a block file
either package writes, the other reads. Host-only: no torch.
"""
from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Callable, List, Optional, Sequence

__all__ = ["DurableLogProducer", "DurableLogConsumer",
           "DurableStreamingTrainer", "write_block_file", "read_block_file",
           "MAX_FRAME"]

_MAGIC = 0xD14A
_HDR = struct.Struct("<HII")  # magic, payload_len, crc32(payload)
#: the bound on one frame's payload: the producer enforces it, so a parsed
#: header claiming more is garbage from a mid-frame resync and the
#: consumer skips it instead of waiting for bytes that never come
MAX_FRAME = 64 * 1024 * 1024


class DurableLogProducer:
    """Append records (JSON-serializable payloads) to a durable log file.
    One producer per process; concurrent producers should use distinct
    partition files (the Kafka partition analog)."""

    def __init__(self, path: str, fsync_every: int = 1):
        self.path = path
        # ENFORCE single-writer: a restarting producer
        # truncates the torn tail, which would corrupt a still-live
        # producer's in-flight frame if two ever shared a partition file.
        # O_CREAT|O_EXCL pid lockfile (works on NFS, unlike flock); stale
        # locks (dead pid on THIS host) are broken automatically.
        self._lock_path = path + ".producer.lock"
        self._acquire_writer_lock()
        try:
            self._truncate_torn_tail(path)
            self._f = open(path, "ab")
        except BaseException:
            self._release_writer_lock()
            raise
        self._fsync_every = max(1, fsync_every)
        self._since_sync = 0

    def _acquire_writer_lock(self) -> None:
        import socket
        host = socket.gethostname()
        unreadable_streak = 0
        for _attempt in range(4):
            try:
                fd = os.open(self._lock_path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, json.dumps({"pid": os.getpid(),
                                         "host": host}).encode())
                os.close(fd)
                return
            except FileExistsError:
                try:
                    with open(self._lock_path) as fh:
                        rec = json.loads(fh.read() or "{}")
                    if not isinstance(rec, dict):
                        rec = {}
                    holder, lhost = int(rec.get("pid", 0)), rec.get("host")
                except (OSError, ValueError):
                    holder, lhost = 0, None
                # liveness is only decidable for a holder on THIS host
                # (pids are host-local); a foreign host's lock is honored —
                # breaking it could let two live producers truncate each
                # other's torn tails on the shared filesystem. A genuinely
                # dead foreign holder needs a manual unlink (documented
                # failure mode, same as any lease-less lockfile).
                stale = False
                if lhost == host and holder > 0:
                    try:
                        os.kill(holder, 0)
                    except ProcessLookupError:
                        stale = True
                    except PermissionError:
                        pass
                elif holder == 0 and lhost is None:
                    # empty/unparsable record: might be a holder BETWEEN
                    # O_EXCL create and write — give it a grace period and
                    # only call it stale if it stays unreadable
                    unreadable_streak += 1
                    if unreadable_streak < 2:
                        time.sleep(0.2)
                        continue
                    stale = True
                if not stale:
                    raise RuntimeError(
                        f"DurableLogProducer: {self.path} is locked by "
                        f"producer pid {holder} on host {lhost!r} "
                        f"(single-writer is enforced; use distinct "
                        f"partition files for concurrent producers, or "
                        f"remove {self._lock_path} if the holder is "
                        f"confirmed dead)")
                self._break_stale_lock(holder, lhost)
        raise RuntimeError(
            f"DurableLogProducer: could not acquire {self._lock_path}")

    def _break_stale_lock(self, holder: int, lhost) -> None:
        """Remove a lock judged stale, SERIALIZED through a breaker lock so
        two concurrent breakers cannot leapfrog each other (without this, B
        can unlink the lock a faster breaker C already re-created, admitting
        two live producers). Under the breaker lock the main lock's content
        is re-verified before the unlink, so only the exact record that was
        judged stale is ever removed. A breaker that crashes mid-break
        leaves the breaker lock behind: breaking disables (loud error, no
        corruption) until the operator removes it."""
        breaker = self._lock_path + ".breaker"
        try:
            bfd = os.open(breaker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            raise RuntimeError(
                f"DurableLogProducer: stale lock {self._lock_path} but "
                f"another breaker is active (or crashed) holding {breaker}; "
                f"remove it manually if no producer start is in flight")
        try:
            os.close(bfd)
            try:
                with open(self._lock_path) as fh:
                    rec = json.loads(fh.read() or "{}")
                if not isinstance(rec, dict):
                    rec = {}
            except FileNotFoundError:
                return  # already broken by the previous breaker
            except (OSError, ValueError):
                rec = {}
            if (int(rec.get("pid", 0)), rec.get("host")) == (holder, lhost):
                try:
                    os.unlink(self._lock_path)
                except OSError:
                    pass
            # else: the lock changed hands since we judged it — leave it
        finally:
            try:
                os.unlink(breaker)
            except OSError:
                pass

    def _release_writer_lock(self) -> None:
        try:
            os.unlink(self._lock_path)
        except OSError:
            pass

    @staticmethod
    def _truncate_torn_tail(path: str) -> None:
        """A producer killed mid-append leaves a torn tail frame. Appending
        fresh frames AFTER it would wedge every consumer forever (the torn
        frame's CRC can never become valid), so a restarting producer scans
        the frame chain and truncates at the first incomplete/corrupt tail
        before appending."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return
        good = 0
        with open(path, "rb") as f:
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    break
                magic, ln, crc = _HDR.unpack(hdr)
                if magic != _MAGIC:
                    break
                payload = f.read(ln)
                if len(payload) < ln or zlib.crc32(payload) != crc:
                    break
                good += _HDR.size + ln
        if good < size:
            with open(path, "r+b") as f:
                f.truncate(good)

    def send(self, record) -> None:
        payload = json.dumps(record).encode()
        if len(payload) > MAX_FRAME:
            raise ValueError(
                f"record serializes to {len(payload)} bytes > MAX_FRAME "
                f"{MAX_FRAME} (split it across records)")
        frame = _HDR.pack(_MAGIC, len(payload), zlib.crc32(payload)) + payload
        self._f.write(frame)
        self._since_sync += 1
        if self._since_sync >= self._fsync_every:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._since_sync = 0

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._since_sync = 0

    def close(self) -> None:
        self.flush()
        self._f.close()
        self._release_writer_lock()


class DurableLogConsumer:
    """Tail a durable log from a persisted, group-scoped cursor.

    ``poll`` returns the next records WITHOUT advancing the durable cursor;
    ``commit`` persists the new offset after the caller has processed them
    (commit-after-process = at-least-once). ``commit_through(n)`` is the
    partial form: it advances the durable cursor past only the first ``n``
    delivered-but-uncommitted records — per-RECORD granularity, not
    per-poll — so a consumer processing a polled batch out of lockstep
    with its durability point (the fleet router acks journal entries as
    replica responses land, not when the batch was read) replays only the
    genuinely unprocessed tail after a crash. The cursor file is written
    atomically (tmp + rename + fsync) — the same torn-write discipline as
    parallel/statetracker.py checkpoints."""

    #: how long a complete-but-CRC-failing frame may stay bad before it is
    #: declared corruption rather than a stale shared-fs read (NFS acregmin
    #: keeps pages/attrs stale up to ~3s with a live writer)
    BADCRC_GRACE_S = 5.0

    def __init__(self, path: str, group: str = "default"):
        self.path = path
        self.cursor_path = f"{path}.{group}.cursor"
        self.offset = self._load_cursor()
        self._pending_offset = self.offset
        # end offset of every record delivered by poll() since the last
        # commit, in delivery order — what commit_through(n) indexes into
        self._delivered_offsets: List[int] = []
        self.corrupt_bytes_skipped = 0  # observability: resync cost so far
        self._badcrc_at = -1  # complete-frame CRC failure awaiting re-check
        self._badcrc_since = 0.0

    def _load_cursor(self) -> int:
        try:
            with open(self.cursor_path) as f:
                return int(json.load(f)["offset"])
        except (OSError, ValueError, KeyError):
            return 0

    def _write_cursor(self, offset: int) -> None:
        tmp = self.cursor_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"offset": offset,
                       "committed_at": time.time()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.cursor_path)
        self.offset = offset

    def commit(self) -> None:
        self._write_cursor(self._pending_offset)
        self._delivered_offsets.clear()

    def commit_through(self, n: int) -> None:
        """Durably commit the first ``n`` records delivered since the
        last commit (cumulative across polls), leaving the rest
        uncommitted: a crash after ``commit_through(n)`` replays from
        record ``n + 1``, not from the whole batch. ``n`` past the
        delivered count is an error — silently clamping would let a
        caller believe work it never read is durable. ``n == 0`` is a
        no-op (nothing newly durable), and re-committing an already
        durable prefix is idempotent."""
        if n < 0 or n > len(self._delivered_offsets):
            raise ValueError(
                f"commit_through({n}): only "
                f"{len(self._delivered_offsets)} uncommitted records "
                "have been delivered")
        if n == 0:
            return
        target = self._delivered_offsets[n - 1]
        if target > self.offset:
            self._write_cursor(target)
        del self._delivered_offsets[:n]

    def poll(self, max_records: int = 256) -> List:
        """Read up to max_records complete frames past the pending offset.
        A torn/incomplete tail frame ends the poll (it will be delivered
        once the producer finishes writing it)."""
        out: List = []
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return out
        if size <= self._pending_offset:
            return out
        with open(self.path, "rb") as f:
            f.seek(self._pending_offset)
            while len(out) < max_records:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    break
                magic, ln, crc = _HDR.unpack(hdr)
                if magic != _MAGIC or ln > MAX_FRAME:
                    # corrupt mid-log byte, or a resync landed on garbage
                    # that parses as a header with an impossible length
                    # (the producer enforces MAX_FRAME, so such a frame can
                    # never complete — waiting would wedge the group);
                    # scan ahead for the next magic to resync
                    self._resync(f)
                    continue
                payload = f.read(ln)
                if len(payload) < ln:
                    # genuine torn tail (bytes missing): WAIT — the live
                    # producer completes it, and a crashed producer's
                    # restart truncates it before appending
                    # (_truncate_torn_tail), which re-syncs us via the
                    # size check above
                    break
                if zlib.crc32(payload) != crc:
                    # COMPLETE frame with a bad CRC. Appends never rewrite
                    # bytes, so real corruption can never become valid —
                    # but on weakly-coherent shared filesystems (NFS /
                    # gcsfuse, the stated substrate) a cross-host reader
                    # can transiently see the extended size with stale
                    # payload pages. poll() reopens the file each call
                    # (close-to-open coherence revalidates caches), so:
                    # the first sighting starts a grace clock; only the
                    # SAME offset still failing after BADCRC_GRACE_S
                    # (sized past NFS attribute-cache staleness, acregmin
                    # default 3s) is deterministic corruption — resync
                    # past it (counted).
                    if self._pending_offset == self._badcrc_at:
                        if (time.monotonic() - self._badcrc_since
                                >= self.BADCRC_GRACE_S):
                            self._badcrc_at = -1
                            self._resync(f)
                            continue
                    else:
                        self._badcrc_at = self._pending_offset
                        self._badcrc_since = time.monotonic()
                    break
                self._badcrc_at = -1
                out.append(json.loads(payload.decode()))
                self._pending_offset += _HDR.size + ln
                self._delivered_offsets.append(self._pending_offset)
        return out

    _MAGIC_BYTES = struct.pack("<H", _MAGIC)
    RESYNC_CHUNK = 1 << 20

    def _resync(self, f) -> None:
        """Advance _pending_offset past a corrupt region to the next magic
        marker (bulk scan — a byte-at-a-time loop through a multi-MB bad
        region would stall the consumer for minutes)."""
        start = self._pending_offset + 1
        f.seek(start)
        buf = f.read(self.RESYNC_CHUNK)
        idx = buf.find(self._MAGIC_BYTES)
        if idx < 0:
            # no magic in the window: skip it all (keep 1 byte of overlap —
            # a marker could straddle the chunk boundary)
            jump = max(len(buf) - 1, 1)
        else:
            jump = idx
        self._pending_offset = start + jump
        self.corrupt_bytes_skipped += 1 + jump
        f.seek(self._pending_offset)

    def lag(self) -> int:
        try:
            return os.path.getsize(self.path) - self.offset
        except OSError:
            return 0


class DurableStreamingTrainer:
    """Train-from-durable-stream loop: tails a DurableLogConsumer,
    converts records, fits the net batch-by-batch, and commits the cursor
    ONLY after the optimizer step ran — a consumer killed mid-batch resumes
    from the last committed batch with no record ever lost. ``net`` is a
    port net (``fit_batch`` moves each numpy batch to its device).
    ``on_batch`` is the listener seam (receives the records just trained,
    post-commit ordering: process -> commit -> notify)."""

    def __init__(self, net, consumer: DurableLogConsumer,
                 converter, batch_size: int = 32,
                 on_batch: Optional[Callable[[Sequence], None]] = None):
        self.net = net
        self.consumer = consumer
        self.converter = converter
        self.batch_size = batch_size
        self.on_batch = on_batch
        self.records_trained = 0

    def run_until_idle(self, idle_timeout: float = 2.0,
                       poll_interval: float = 0.05,
                       max_records: Optional[int] = None) -> int:
        """Consume until the log stays quiet for idle_timeout seconds (or
        max_records have been processed this call). Returns records
        processed this call."""
        processed = 0
        deadline = time.monotonic() + idle_timeout
        while True:
            want = self.batch_size
            if max_records is not None:
                want = min(want, max_records - processed)
                if want <= 0:
                    return processed
            records = self.consumer.poll(want)
            if not records:
                if time.monotonic() >= deadline:
                    return processed
                time.sleep(poll_interval)
                continue
            deadline = time.monotonic() + idle_timeout
            ds = self.converter.convert(records)
            self.net.fit_batch(ds.features, ds.labels)
            self.consumer.commit()  # at-least-once: commit AFTER the step
            self.records_trained += len(records)
            processed += len(records)
            if self.on_batch is not None:
                self.on_batch(records)


# -- single-block files (the KV tiers' disk store) -----------------------
# One evicted prefix block per file, with the log's frame discipline: a
# process killed mid-spill leaves no file or a complete frame, so a torn
# or corrupt file reads as a cache miss, never as wrong bytes.

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
