"""Fault tolerance: checkpoint-based training state tracking and elastic
resume — port of deeplearning4j_tpu/parallel/statetracker.py (:38-424).

Capability parity with the reference's legacy distributed runtime
(`scaleout/api/statetracker/StateTracker.java:45`: per-worker job
persistence and redelivery :122-129, the worker lifecycle :184-199), as in
the JAX package. The durable substrate is the checkpoint file: the tracker
writes an ATOMIC checkpoint every ``every_n_batches`` batches — the shared
model zip (`util/model_serializer`: config + flat f32 params + updater
state + variables + step) with a ``cursor.json`` beside them (epoch, batch
index, whatever the driver passes) — by write-to-temp, fsync and
`os.replace`, so a kill at any instant loses at most that many batches and
never corrupts state; `restore` takes the newest intact checkpoint. So a
checkpoint the port writes restores in the JAX package, and the reverse,
with the same params.

The host RNG part of the cursor is the port's own: ``torch_rng``, the
net's `torch.Generator` state (dropout masks), in place of the JAX
package's PRNG key. For the JAX package to read a port checkpoint the
cursor also carries ``rng_key``, the JAX key of the conf's seed
(``PRNGKey(seed)``); neither package takes the other's RNG stream, a
deliberate difference (ROADMAP C).

Under a data-parallel master (`parallel/trainer.py`) the tracker runs on
the driver (rank 0), whose net holds the job's state; a multi-process
`resume()` restores there and re-syncs the followers.
"""
from __future__ import annotations

import base64
import json
import os
import time
import zipfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import torch

CURSOR_JSON = "cursor.json"


def _jax_key_of_seed(seed: int) -> List[int]:
    """The JAX package's ``PRNGKey(seed)`` as two uint32 words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return [seed >> 32, seed & 0xFFFFFFFF]


def _conf_seed(net) -> int:
    conf = net.conf
    return int(getattr(getattr(conf, "conf", conf), "seed", 0) or 0)


class TrainingStateTracker:
    """Periodic atomic checkpoints + restore (StateTracker.java:45 analog).

    Checkpoints are complete: params, updater state, BN variables, step
    counter, the host RNG state, and a caller-supplied cursor — so a
    resumed run continues as an uninterrupted one (given the same data
    order), which the kill-mid-training test asserts.
    """

    def __init__(self, directory: Union[str, Path], every_n_batches: int = 10,
                 keep_last: int = 2):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every_n_batches = max(1, every_n_batches)
        self.keep_last = max(1, keep_last)
        self._since_save = 0
        # worker lifecycle registry (reference addWorker/disableWorker
        # :184-199). PERSISTED to the shared checkpoint directory (the
        # reference keeps it in ZooKeeper-backed shared state): a job
        # restarted after a host failure must see the same roster so it
        # can disable the dead worker and re-shard (elastic-recovery test
        # in tests/test_multihost.py).
        self._workers: Dict[str, bool] = self._load_workers()

    # -- worker lifecycle (reference :184-199) ---------------------------------
    # One FILE PER WORKER, merged on read. The roster lives on a shared
    # checkpoint substrate (NFS / GCS-fuse) where flock is unreliable
    # (gcsfuse: silent no-op; NFS: mount-dependent), so any cross-host
    # read-merge-write of a single roster file can lose registrations.
    # Per-worker files need no cross-host mutual exclusion at all: distinct
    # workers touch distinct files, and same-worker mutations are owned by
    # that worker (or the master that declared it dead) with atomic
    # last-writer-wins via os.replace.
    def _workers_dir(self) -> Path:
        return self.dir / "workers"

    @staticmethod
    def _worker_file_stem(worker_id: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in worker_id)
        if safe != worker_id:  # collision-proof the sanitized name
            import hashlib
            safe += "-" + hashlib.sha1(worker_id.encode()).hexdigest()[:8]
        return safe

    def _load_workers(self) -> Dict[str, bool]:
        merged: Dict[str, bool] = {}
        try:  # legacy single-file roster, lowest precedence
            with open(self.dir / "workers.json") as fh:
                merged.update({str(k): bool(v)
                               for k, v in json.load(fh).items()})
        except (OSError, ValueError):
            pass
        wd = self._workers_dir()
        if wd.is_dir():
            for f in sorted(wd.glob("*.json")):
                try:
                    with open(f) as fh:
                        rec = json.load(fh)
                    merged[str(rec["id"])] = bool(rec["enabled"])
                except (OSError, ValueError, KeyError):
                    continue  # torn write: skip, the owner will rewrite
        return merged

    def _mutate_workers(self, worker_id: str, value, *,
                        keep_existing: bool) -> None:
        wd = self._workers_dir()
        wd.mkdir(parents=True, exist_ok=True)
        path = wd / f"{self._worker_file_stem(worker_id)}.json"
        payload = json.dumps({"id": worker_id, "enabled": bool(value)})
        if keep_existing:
            # add_worker must never OVERWRITE concurrent state: a master
            # disabling this worker races the worker re-registering. Respect
            # the merged roster (covers the legacy single-file format), then
            # create with O_EXCL — if the file exists (or appears between
            # check and create), the existing record wins; if we win the
            # create, a concurrent disable's os.replace lands after and
            # wins. Both orders converge to the disable — the guarantee the
            # old flock'd read-merge-write gave on substrates where flock
            # actually works, now without needing it.
            if worker_id not in self._load_workers():
                # write the FULL record to a unique tmp first, then claim
                # the name with os.link (fails if present, like O_EXCL, but
                # the visible file always has complete content): a crash
                # between a direct O_EXCL create and its write would leave
                # a permanent empty poison file this worker could never
                # re-register past
                tmp = path.with_suffix(f".add.{os.getpid()}.{id(self):x}")
                with open(tmp, "w") as fh:
                    fh.write(payload)
                    fh.flush()
                    os.fsync(fh.fileno())
                try:
                    os.link(tmp, path)
                except FileExistsError:
                    # a record exists: it wins — unless it is an EMPTY/torn
                    # leftover of a crashed add (a poison file nothing would
                    # ever rewrite): heal it with our complete record
                    try:
                        if os.path.getsize(path) == 0:
                            os.replace(tmp, path)
                            tmp = None
                    except OSError:
                        pass
                except OSError:
                    # hard links unsupported (gcsfuse): fall back to the
                    # atomic-visibility rename. The lost property is only
                    # create-if-absent firstness for simultaneous adds of
                    # the SAME new worker with different values — add
                    # always writes enabled=True, so both writers agree
                    os.replace(tmp, path)
                    tmp = None
                finally:
                    if tmp is not None:
                        try:
                            os.unlink(tmp)
                        except OSError:
                            pass
        else:
            # enable/disable: atomic last-writer-wins overwrite; unique tmp
            # name so two hosts mutating the same worker cannot clobber
            # each other's in-flight tmp before the rename
            tmp = path.with_suffix(f".tmp.{os.getpid()}.{id(self):x}")
            with open(tmp, "w") as fh:
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        self._workers = self._load_workers()

    def add_worker(self, worker_id: str) -> None:
        self._mutate_workers(worker_id, True, keep_existing=True)

    def enable_worker(self, worker_id: str) -> None:
        self._mutate_workers(worker_id, True, keep_existing=False)

    def disable_worker(self, worker_id: str) -> None:
        self._mutate_workers(worker_id, False, keep_existing=False)

    def workers(self) -> List[str]:
        return sorted(self._workers)

    def enabled_workers(self) -> List[str]:
        return sorted(w for w, ok in self._workers.items() if ok)

    # -- checkpoint write ------------------------------------------------------
    def _checkpoint_paths(self) -> List[Path]:
        return sorted(self.dir.glob("ckpt-*.zip"),
                      key=lambda p: int(p.stem.split("-")[1]))

    def save(self, net, cursor: Optional[dict] = None) -> Path:
        """Write one atomic checkpoint. `cursor` is arbitrary JSON state the
        training driver needs to resume (epoch, batch index, ...)."""
        path = self._write(net, cursor)
        self._since_save = 0
        return path

    def _write(self, net, cursor: Optional[dict] = None) -> Path:
        """The serialization itself — does NOT touch the batch counter (the
        async tracker runs this on its writer thread, where resetting
        `_since_save` would wipe batch_done counts accumulated during a
        slow write and stretch the loss bound past every_n_batches)."""
        from ..util.model_serializer import write_model
        seq_prev = [int(p.stem.split("-")[1]) for p in self._checkpoint_paths()]
        seq = (max(seq_prev) + 1) if seq_prev else 0
        final = self.dir / f"ckpt-{seq:08d}.zip"
        tmp = self.dir / f".ckpt-{seq:08d}.zip.tmp"
        write_model(net, tmp, save_updater=True)
        # append the cursor (+ the host RNG state) into the same zip
        cur = dict(cursor or {})
        state = getattr(net, "_rng_state", None)
        if state is None:
            state = net._gen.get_state()
        cur["torch_rng"] = base64.b64encode(
            state.cpu().numpy().tobytes()).decode("ascii")
        cur["rng_key"] = _jax_key_of_seed(_conf_seed(net))
        cur["step"] = int(net.step)
        cur["wall_time"] = time.time()
        with zipfile.ZipFile(tmp, "a", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(CURSOR_JSON, json.dumps(cur))
        with open(tmp, "rb") as fh:  # durability before the atomic rename
            os.fsync(fh.fileno())
        os.replace(tmp, final)
        for old in self._checkpoint_paths()[:-self.keep_last]:
            try:
                old.unlink()
            except OSError:
                pass
        return final

    def batch_done(self, net, cursor: Optional[dict] = None) -> Optional[Path]:
        """Call once per trained batch; saves every `every_n_batches`."""
        self._since_save += 1
        if self._since_save >= self.every_n_batches:
            return self.save(net, cursor)
        return None

    def wait(self) -> Optional[Path]:
        """Synchronous tracker: every save is already durable; no-op.
        (AsyncTrainingStateTracker overrides this to join its writer.)"""
        return None

    # -- restore ---------------------------------------------------------------
    def latest(self) -> Optional[Path]:
        paths = self._checkpoint_paths()
        return paths[-1] if paths else None

    def restore(self, net) -> Optional[dict]:
        """Restore the newest INTACT checkpoint into `net` (a kill during
        save leaves a .tmp which is ignored; a torn final file falls back to
        the previous checkpoint). Returns the cursor or None."""
        import zlib
        for path in reversed(self._checkpoint_paths()):
            try:
                return self._restore_one(net, path)
            except (zipfile.BadZipFile, KeyError, OSError, ValueError,
                    RuntimeError, zlib.error):
                continue  # torn OR bit-corrupted file -> fall back
        return None

    def _restore_one(self, net, path: Path) -> dict:
        """One checkpoint into ``net``. A JAX checkpoint carries no
        ``torch_rng``: the net's generator stays as it is."""
        from ..util.model_serializer import _restore_state
        with zipfile.ZipFile(path) as zf:
            cursor = json.loads(zf.read(CURSOR_JSON).decode())
            cursor.pop("rng_key")
            rng = cursor.pop("torch_rng", None)
            net._check_init()
            _restore_state(net, zf, load_updater=True)
        if rng is not None:
            net._gen.set_state(torch.frombuffer(
                bytearray(base64.b64decode(rng)), dtype=torch.uint8))
        net.step = int(cursor.get("step", net.step))
        return cursor


def _snapshot(net):
    """A point-in-time snapshot of a net's training state, taken on the
    training thread: each tensor is cloned on its device (on the card the
    copy is only queued, behind the step that wrote it and ahead of any
    later step, which updates the net's tensors in place), with the step
    and the generator's state. The writer thread's device-to-host reads
    wait for the clones alone."""
    def leaf(t):
        if isinstance(t, torch.Tensor):
            return t.detach().clone()
        if isinstance(t, dict):
            return {k: leaf(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(leaf(v) for v in t)
        return t

    snap = object.__new__(type(net))
    # a tensor-parallel or ZeRO-1 net's whole state is read here, on the
    # training thread; the snapshot keeps no tie to the ranks
    snap.__dict__.update({k: v for k, v in net.__dict__.items()
                          if k not in ("params", "updater_state",
                                       "variables", "_params",
                                       "_updater_state", "_tp", "_zero")})
    snap.params = leaf(net.params)
    snap.updater_state = leaf(net.updater_state)
    snap.variables = leaf(net.variables)
    snap.step = int(net.step)
    snap._rng_state = net._gen.get_state()
    return snap


class AsyncTrainingStateTracker(TrainingStateTracker):
    """Async checkpointing: `save()` queues device-side copies of the
    state on the training thread (`_snapshot`) and returns at once; one
    background writer thread does the device->host fetch, zip
    serialization, fsync and atomic rename. The training loop never
    stalls on checkpoint IO.

    At most one save is in flight (a new `save()` first waits for the
    previous one, surfacing any writer error there); `wait()` blocks until
    the pending checkpoint is durable; `restore()`/`close()` imply `wait()`.
    Kill-safety is inherited: the writer goes through the same
    write-tmp -> fsync -> os.replace protocol, so dying mid-save leaves the
    previous checkpoint intact.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        import concurrent.futures
        self._writer = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending = None

    def save(self, net, cursor: Optional[dict] = None):
        """Snapshot now, write in the background. Returns a Future[Path]."""
        self.wait()  # bound in-flight saves to 1; surface earlier failures
        snap = _snapshot(net)
        cur = dict(cursor or {})
        self._pending = self._writer.submit(self._write, snap, cur)
        self._since_save = 0
        return self._pending

    def wait(self) -> Optional[Path]:
        """Block until the in-flight checkpoint (if any) is durable."""
        pending, self._pending = self._pending, None
        return pending.result() if pending is not None else None

    def restore(self, net) -> Optional[dict]:
        self.wait()
        return super().restore(net)

    def close(self) -> None:
        """Make the in-flight save durable and release the writer thread.
        The shutdown happens even when the pending write failed (the error
        still propagates)."""
        try:
            self.wait()
        finally:
            self._writer.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            # the with-body's exception wins; still release the writer and
            # don't let a failed background save replace it
            try:
                self.close()
            except Exception:
                pass
            return False
        self.close()
        return False


def fit_with_recovery(net, make_iterator: Callable[[int], object],
                      epochs: int, tracker: TrainingStateTracker,
                      master=None) -> dict:
    """Resumable multi-epoch training — the `resume()` entry point.

    `make_iterator(epoch)` must return the SAME batch sequence for a given
    epoch on every invocation (deterministic data order is what makes
    recovery exact — the reference redelivers the same persisted job,
    StateTracker.java:122-129). If `master` is given, each batch is trained
    through `master.execute_training` (distributed path); otherwise through
    the net's own single-batch fit.

    On entry, restores the newest checkpoint (if any) and replays forward
    from its cursor. A process kill at ANY point (including mid-save) loses
    at most `tracker.every_n_batches` batches of progress and resumes to the
    same final state an uninterrupted run reaches.
    """
    cursor = tracker.restore(net) or {}
    start_epoch = int(cursor.get("epoch", 0))
    start_batch = int(cursor.get("batch", 0))
    # this driver owns the cursor: suspend any master-side checkpoint hook
    # so each batch is recorded exactly once, in THIS epoch/batch vocabulary
    master_tracker = getattr(master, "state_tracker", None)
    if master is not None and master_tracker is not None:
        master.state_tracker = None
    try:
        _fit_with_recovery_loop(net, make_iterator, epochs, tracker, master,
                                start_epoch, start_batch)
    finally:
        if master is not None and master_tracker is not None:
            master.state_tracker = master_tracker
    tracker.save(net, {"epoch": epochs, "batch": 0, "done": True})
    tracker.wait()  # async trackers: the final checkpoint must be durable
    return {"epochs": epochs, "final_step": net.step}


def _fit_with_recovery_loop(net, make_iterator, epochs, tracker, master,
                            start_epoch, start_batch):
    for epoch in range(start_epoch, epochs):
        it = make_iterator(epoch)
        if hasattr(it, "reset"):
            it.reset()
        pull = (it.next_batch if hasattr(it, "next_batch")
                else iter(it).__next__)
        bi = 0
        while True:
            try:
                ds = pull()
            except StopIteration:
                ds = None
            if ds is None:
                break
            if epoch == start_epoch and bi < start_batch:
                bi += 1
                continue  # already trained before the checkpoint
            if master is not None:
                master.execute_training(net, [ds])
            elif hasattr(net.conf, "vertices"):
                net.fit(ds)  # ComputationGraph: one (Multi)DataSet
            else:  # MultiLayerNetwork
                net.fit_batch(ds.features, ds.labels,
                              getattr(ds, "features_mask", None),
                              getattr(ds, "labels_mask", None))
            bi += 1
            tracker.batch_done(net, {"epoch": epoch, "batch": bi})
        start_batch = 0
