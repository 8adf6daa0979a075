"""Process-group meshes — the port's counterpart of
deeplearning4j_tpu/parallel/mesh.py.

JAX runs one controller and GSPMD partitions each jitted program over a
`jax.sharding.Mesh`. PyTorch has no single-controller partitioner, so the
port takes the Megatron / vLLM idiom instead: a mesh is a group of
processes, one a rank, and **rank 0 is the driver** — the caller's own
process — while ranks 1..N-1 are **followers** that the mesh starts with
`torch.multiprocessing` (spawn). The ranks rendezvous through a
`torch.distributed.FileStore` in a fresh temporary directory (never a fixed
TCP port, so concurrent meshes never collide) into a standalone process
group: NCCL when every rank has a CUDA card of its own, else gloo (CPU
ranks, or ranks co-located on one card, which NCCL refuses; gloo moves
CUDA tensors through host staging). `backend_for` states the rule.

The command loop. A follower runs `_follower_main`: it waits for the
driver's next command — one broadcast of a fixed-capacity int32 vector
``[op, service, a0..a7, payload length | payload]`` — and executes it.
``ATTACH`` (followed by one data broadcast of the pickled spec) builds a
service on the follower from a factory named by module path: the decode
engine's shard (`inference/engine.py`) or a training replica
(`parallel/trainer.py`); later commands with that service id go to its
``handle(cmd)``, which runs the same device operation as the driver on
the rank's own shard, with the same collectives in the same order.

Every collective is counted per process in `COUNTS`: ``all_reduce``,
``all_gather``, ``broadcast_command`` (one a dispatch) and
``broadcast_data``, like `ops.cuda_kernels.LAUNCHES` counts kernel
launches (`inference/sharding.collective_counts` reads them).

A follower that dies makes the driver's next collective raise (gloo
reports the closed connection at once), and the driver checks that every
follower is alive before each command; the caller (the decode engine, a
training master) turns that into its own failure. An idle driver sends a
no-op command every quarter of the group's ``timeout`` so that a
follower's wait never times out. A size-1 mesh starts no process: its
collectives are no-ops.

Axis names follow the JAX package: "data" (data parallelism), "model"
(tensor parallelism in training), "seq", "pipe", "expert", and the
decode engine's "tp" (`inference/sharding.TP_AXIS`). Only 1-D meshes
exist in this slice: `make_mesh` takes one axis; `hybrid_mesh` and
`mesh_2d` are listed in ROADMAP.md (A7).
"""
from __future__ import annotations

import atexit
import collections
import datetime
import importlib
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"

#: timings a rank's services record (seconds or bytes, by name), read
#: across ranks by `ProcessMesh.query_stats`
STATS: Dict[str, float] = {}

#: collective calls of this process, by kind
COUNTS: collections.Counter = collections.Counter()
COLLECTIVE_KINDS = ("all_reduce", "all_gather", "broadcast_command",
                    "broadcast_data")

# command ops of the loop itself; services number theirs from 16
OP_NOOP, OP_STOP, OP_RESIZE, OP_ATTACH, OP_DETACH = 0, 1, 2, 3, 4
OP_COUNTS_RESET, OP_COUNTS_QUERY = 5, 6
OP_LAUNCHES_RESET, OP_LAUNCHES_QUERY, OP_STATS_QUERY = 7, 8, 9
SERVICE_OPS = 16
N_ARGS = 8
HDR = 3 + N_ARGS  # op, service, args, payload length
_DEFAULT_CMD = 256


class MeshError(RuntimeError):
    """A rank of the mesh died or a collective failed."""


def _norm_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d!r} (a rank runs on 'cpu' "
                         "or 'cuda:<i>')")
    return dev


def backend_for(devices: Sequence) -> str:
    """The process group's backend for a device list: ``"nccl"`` when
    every rank has a CUDA card of its own, else ``"gloo"`` (CPU ranks, a
    mix, or ranks sharing a card — NCCL refuses two ranks on one
    device)."""
    devs = [_norm_device(d) for d in devices]
    if devs and all(d.type == "cuda" for d in devs) \
            and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def backend_flags() -> Dict[str, bool]:
    """This process's numerics switches (TF32, cuDNN's determinism), which
    a follower takes on so that its ranks compute as the driver does."""
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "cudnn_benchmark": torch.backends.cudnn.benchmark}


def set_backend_flags(flags: Dict[str, bool]) -> None:
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn_tf32"]
    torch.backends.cudnn.deterministic = flags["cudnn_deterministic"]
    torch.backends.cudnn.benchmark = flags["cudnn_benchmark"]


def _make_pg(path: str, rank: int, size: int, backend: str,
             timeout: float):
    import torch.distributed as dist
    store = dist.FileStore(path, size)
    td = datetime.timedelta(seconds=float(timeout))
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = td
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    return dist.ProcessGroupGloo(store, rank, size, td)


class Command:
    """A decoded command: ``op``, ``service``, ``args`` (N_ARGS ints) and
    the int32 ``payload``."""
    __slots__ = ("op", "service", "args", "payload")

    def __init__(self, vec: np.ndarray):
        self.op = int(vec[0])
        self.service = int(vec[1])
        self.args = [int(a) for a in vec[2:2 + N_ARGS]]
        n = int(vec[2 + N_ARGS])
        self.payload = vec[HDR:HDR + n].copy()


class _Comm:
    """The collectives of one rank, counted in `COUNTS`. ``rank``,
    ``size``, ``device`` (this rank's), ``backend``."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    backend: str = "gloo"
    _pg = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        if self.size == 1:
            return t
        COUNTS["all_reduce"] += 1
        self._pg.allreduce([t]).wait()
        return t

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated along the last axis, rank order."""
        return self.all_gather(t, -1)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim``, rank order, on
        ``t``'s device (a CPU tensor under NCCL travels through the
        rank's card)."""
        if self.size == 1:
            return t
        COUNTS["all_gather"] += 1
        src = t.contiguous()
        if self.backend == "nccl" and src.device.type != "cuda":
            src = src.to(self.device)
        outs = [torch.empty_like(src) for _ in range(self.size)]
        self._pg.allgather([outs], [src]).wait()
        return torch.cat(outs, dim=dim).to(t.device)

    def broadcast_data(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` into every rank's ``t``, in place."""
        if self.size == 1:
            return t
        COUNTS["broadcast_data"] += 1
        if self.backend == "nccl" and t.device.type != "cuda":
            d = t.to(self.device)
            self._pg.broadcast(d, 0).wait()
            return t.copy_(d.cpu())
        self._pg.broadcast(t, 0).wait()
        return t

    def broadcast_bytes(self, data: Optional[bytes], n: int) -> bytes:
        """Rank 0's ``n`` bytes (``data``) on every rank: one data
        broadcast."""
        buf = torch.zeros(n, dtype=torch.uint8)
        if data is not None:
            buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
        return self.broadcast_data(buf).numpy().tobytes()

    def _gather_vec(self, own: torch.Tensor) -> List[torch.Tensor]:
        outs = [torch.zeros_like(own) for _ in range(self.size)]
        if self.backend == "nccl":
            dev = [o.to(self.device) for o in outs]
            self._pg.allgather([dev], [own.to(self.device)]).wait()
            return [o.cpu() for o in dev]
        self._pg.allgather([outs], [own]).wait()
        return outs

    def _counts_vector(self) -> torch.Tensor:
        return torch.tensor([COUNTS[k] for k in COLLECTIVE_KINDS],
                            dtype=torch.int64)

    def _gather_counts(self, own: torch.Tensor) -> List[Dict[str, int]]:
        return [dict(zip(COLLECTIVE_KINDS, (int(v) for v in o)))
                for o in self._gather_vec(own)]


class _Follower(_Comm):
    """Rank r > 0 inside its own process: receives commands."""

    def __init__(self, pg, rank, size, device, backend, cmd_len):
        self._pg = pg
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self._cmd_len = cmd_len

    def recv_command(self) -> Command:
        buf = torch.zeros(self._cmd_len, dtype=torch.int32)
        if self.backend == "nccl":
            buf = buf.to(self.device)
        self._pg.broadcast(buf, 0).wait()
        COUNTS["broadcast_command"] += 1
        return Command(buf.cpu().numpy())


def _launch_keys() -> List[str]:
    from ..ops import cuda_kernels as ck
    return sorted(ck.LAUNCHES)


def _launches_vector() -> torch.Tensor:
    from ..ops import cuda_kernels as ck
    return torch.tensor([ck.LAUNCHES[k] for k in _launch_keys()],
                        dtype=torch.int64)


def _launches_reset() -> None:
    from ..ops import cuda_kernels as ck
    for k in ck.LAUNCHES:
        ck.LAUNCHES[k] = 0


def _stats_vector(names: Sequence[str]) -> torch.Tensor:
    return torch.tensor([float(STATS.get(n, float("nan"))) for n in names],
                        dtype=torch.float64)


def _load(path: str) -> Callable:
    mod, name = path.split(":")
    return getattr(importlib.import_module(mod), name)


def _follower_main(rank: int, size: int, store_path: str, device: str,
                   backend: str, timeout: float, cmd_len: int,
                   flags: Dict[str, bool]) -> None:
    """A follower process: join the group, then execute commands until
    ``STOP``. A service that raises ends the process (the driver's next
    collective then fails), after printing the traceback."""
    set_backend_flags(flags)
    dev = _norm_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    pg = _make_pg(store_path, rank, size, backend, timeout)
    me = _Follower(pg, rank, size, dev, backend, cmd_len)
    services: Dict[int, Any] = {}
    try:
        while True:
            cmd = me.recv_command()
            op = cmd.op
            if op == OP_NOOP:
                continue
            if op == OP_STOP:
                break
            if op == OP_RESIZE:
                me._cmd_len = cmd.args[0]
            elif op == OP_ATTACH:
                spec = pickle.loads(me.broadcast_bytes(None, cmd.args[0]))
                services[cmd.service] = _load(spec["factory"])(
                    me, spec["payload"])
            elif op == OP_DETACH:
                svc = services.pop(cmd.service, None)
                close = getattr(svc, "close", None)
                if close is not None:
                    close()
            elif op == OP_COUNTS_RESET:
                COUNTS.clear()
            elif op == OP_COUNTS_QUERY:
                own = me._counts_vector()
                # the query's own command broadcast is not part of what
                # was measured
                own[COLLECTIVE_KINDS.index("broadcast_command")] -= 1
                me._gather_counts(own)
            elif op == OP_LAUNCHES_RESET:
                _launches_reset()
            elif op == OP_LAUNCHES_QUERY:
                me._gather_vec(_launches_vector())
            elif op == OP_STATS_QUERY:
                names = pickle.loads(me.broadcast_bytes(None, cmd.args[0]))
                me._gather_vec(_stats_vector(names))
            else:
                services[cmd.service].handle(cmd)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    os._exit(0)


_LIVE: "weakref.WeakSet[ProcessMesh]" = weakref.WeakSet()


class ProcessMesh(_Comm):
    """A 1-D mesh of ``n`` ranks over ``devices`` (one a rank; rank 0 is
    this process, on ``devices[0]``). Default devices: ``cuda:0`` ..
    ``cuda:n-1``, which raises when the machine has fewer cards; ranks
    sharing a card (``["cuda:0"] * n``) and CPU ranks (``["cpu"] * n``)
    are the caller's explicit choice. ``timeout`` (seconds): the process
    group's timeout, for the rendezvous and every collective.

    The followers start at the first `start()` (an engine or a master
    starts the mesh it is given), and again after `kill()` or a dead
    follower; `close()` stops them. ``shape`` and ``axis_names`` read as
    a JAX mesh's do."""

    def __init__(self, n: int, devices: Optional[Sequence] = None,
                 axis: str = DATA_AXIS, timeout: float = 300.0):
        n = int(n)
        if n < 1:
            raise ValueError(f"a mesh needs >= 1 rank, got {n}")
        if devices is None:
            devices = [f"cuda:{i}" for i in range(n)]
        devs = [_norm_device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"{n} ranks need {n} devices, got {len(devs)}")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        need = max([d.index + 1 for d in devs if d.type == "cuda"],
                   default=0)
        if need > cards:
            raise ValueError(
                f"mesh over {[str(d) for d in devs]} needs {need} CUDA "
                f"card(s), this machine has {cards} (co-locate ranks with "
                "devices=['cuda:0'] * n, or pass devices=['cpu'] * n)")
        self.size = n
        self.devices = devs
        self.device = devs[0]
        self.rank = 0
        self.axis_names = (axis,)
        self.shape = {axis: n}
        self.backend = backend_for(devs)
        self.timeout = float(timeout)
        self._pg = None
        self._procs: List[Any] = []
        self._dir: Optional[str] = None
        self._cmd_len = _DEFAULT_CMD
        self._lock = threading.RLock()
        self._last = time.monotonic()
        self._next_service = 1
        self._keepalive: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self.starts = 0  # times the followers were started

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, devices="
                f"{[str(d) for d in self.devices]}, backend={self.backend})")

    # -- lifecycle ---------------------------------------------------------
    def alive(self) -> bool:
        """Every follower runs (a size-1 mesh is always alive)."""
        if self.size == 1:
            return True
        return self._pg is not None and all(p.is_alive() for p in self._procs)

    def start(self) -> "ProcessMesh":
        """Start the followers and join the group (a no-op while they
        run; a mesh with a dead follower is killed and started anew)."""
        with self._lock:
            if self.size == 1 or (self._pg is not None and self.alive()):
                return self
            self.kill()
            import torch.multiprocessing as mp
            self._dir = tempfile.mkdtemp(prefix="dl4j-mesh-")
            path = os.path.join(self._dir, "store")
            ctx = mp.get_context("spawn")
            self._cmd_len = _DEFAULT_CMD
            self._procs = [ctx.Process(
                target=_follower_main,
                args=(r, self.size, path, str(self.devices[r]), self.backend,
                      self.timeout, self._cmd_len, backend_flags()),
                daemon=True)
                for r in range(1, self.size)]
            for p in self._procs:
                p.start()
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                self._pg = _make_pg(path, 0, self.size, self.backend,
                                    self.timeout)
            except BaseException:
                self.kill()
                raise
            self.starts += 1
            self._last = time.monotonic()
            self._closed.clear()
            _LIVE.add(self)
            if self._keepalive is None or not self._keepalive.is_alive():
                self._keepalive = threading.Thread(
                    target=self._keepalive_loop, daemon=True,
                    name="mesh-keepalive")
                self._keepalive.start()
        return self

    def _keepalive_loop(self) -> None:
        period = max(0.5, self.timeout / 4.0)
        while not self._closed.wait(min(period, 5.0)):
            if time.monotonic() - self._last < period:
                continue
            if not self._lock.acquire(blocking=False):
                continue  # a dispatch is running: it counts as traffic
            try:
                if self._pg is not None and self.alive():
                    self._send(OP_NOOP, 0, (), None, count=False)
            except Exception:
                pass  # the next real dispatch reports the failure
            finally:
                self._lock.release()

    def kill(self) -> None:
        """Stop the followers at once (SIGKILL) and drop the group: a
        driver blocked in a collective with them fails instead of
        waiting."""
        with self._lock:
            for p in self._procs:
                if p.is_alive():
                    p.kill()
            for p in self._procs:
                p.join(timeout=10)
            self._procs = []
            self._pg = None
            if self._dir is not None:
                shutil.rmtree(self._dir, ignore_errors=True)
                self._dir = None
            self._closed.set()

    def close(self, timeout: float = 10.0) -> None:
        """Ask the followers to exit, join them (killing any that
        outlive ``timeout``) and drop the group."""
        with self._lock:
            if self._pg is not None and self.alive():
                try:
                    self._send(OP_STOP, 0, (), None, count=False)
                except Exception:
                    pass
            deadline = time.monotonic() + timeout
            for p in self._procs:
                p.join(timeout=max(0.0, deadline - time.monotonic()))
            self.kill()
            _LIVE.discard(self)

    # -- commands ----------------------------------------------------------
    def _check_alive(self) -> None:
        if self.size == 1:
            return
        if self._pg is None:
            raise MeshError("the mesh is not started (or was killed)")
        for r, p in enumerate(self._procs, start=1):
            if not p.is_alive():
                raise MeshError(f"mesh follower rank {r} exited (code "
                                f"{p.exitcode})")

    def _send(self, op: int, service: int, args: Sequence[int],
              payload: Optional[np.ndarray], count: bool = True) -> None:
        n = 0 if payload is None else int(payload.shape[0])
        if HDR + n > self._cmd_len:
            self._resize(HDR + n)
        vec = np.zeros(self._cmd_len, np.int32)
        vec[0] = op
        vec[1] = service
        a = list(args)
        if len(a) > N_ARGS:
            raise ValueError(f"at most {N_ARGS} command args, got {len(a)}")
        vec[2:2 + len(a)] = a
        vec[2 + N_ARGS] = n
        if n:
            vec[HDR:HDR + n] = payload
        buf = torch.from_numpy(vec)
        if self.backend == "nccl":
            buf = buf.to(self.device)
        self._pg.broadcast(buf, 0).wait()
        if count:
            COUNTS["broadcast_command"] += 1
        self._last = time.monotonic()

    def _resize(self, need: int) -> None:
        new = max(need, 2 * self._cmd_len)
        self._send(OP_RESIZE, 0, (new,), None, count=False)
        self._cmd_len = new

    def command(self, op: int, service: int, args: Sequence[int] = (),
                payload: Optional[np.ndarray] = None) -> None:
        """Broadcast one command (one ``broadcast_command``); the caller
        holds `exclusive()` across it and the work it starts."""
        if self.size == 1:
            return
        self._check_alive()
        try:
            self._send(op, service, args, payload)
        except Exception as e:
            raise MeshError(f"command broadcast failed: {e}") from e

    def exclusive(self):
        """The driver's lock around one dispatch (its command and the
        collectives of the work it starts), so that no keep-alive command
        falls between them."""
        return self._lock

    def attach(self, factory: str, payload: Any) -> int:
        """Build a service on every follower: ``factory`` names a
        callable ``module:name`` taking (the follower's comm, payload).
        Returns the service id for `command`."""
        with self._lock:
            sid = self._next_service
            self._next_service += 1
            if self.size == 1:
                return sid
            self.start()
            data = pickle.dumps({"factory": factory, "payload": payload},
                                protocol=pickle.HIGHEST_PROTOCOL)
            self.command(OP_ATTACH, sid, (len(data),))
            self.broadcast_bytes(data, len(data))
            return sid

    def detach(self, service: int) -> None:
        """Drop a service on the followers (a no-op on a dead mesh)."""
        with self._lock:
            if self.size == 1 or not self.alive():
                return
            try:
                self.command(OP_DETACH, service)
            except MeshError:
                pass

    def reset_counts(self) -> None:
        """Zero `COUNTS` on every rank."""
        with self._lock:
            self.command(OP_COUNTS_RESET, 0)
            COUNTS.clear()

    def query_counts(self) -> List[Dict[str, int]]:
        """Every rank's `COUNTS` (rank order), as they stood before this
        query."""
        with self._lock:
            own = self._counts_vector()
            if self.size == 1:
                return [dict(zip(COLLECTIVE_KINDS, (int(v) for v in own)))]
            self._send(OP_COUNTS_QUERY, 0, (), None, count=False)
            return self._gather_counts(own)


    def reset_launches(self) -> None:
        """Zero `ops.cuda_kernels.LAUNCHES` on every rank."""
        with self._lock:
            self.command(OP_LAUNCHES_RESET, 0)
            _launches_reset()

    def query_launches(self) -> List[Dict[str, int]]:
        """Every rank's kernel launch counts (rank order)."""
        with self._lock:
            own = _launches_vector()
            if self.size > 1:
                self._send(OP_LAUNCHES_QUERY, 0, (), None, count=False)
                vecs = self._gather_vec(own)
            else:
                vecs = [own]
            keys = _launch_keys()
            return [dict(zip(keys, (int(v) for v in vec))) for vec in vecs]

    def query_stats(self, names: Sequence[str]) -> List[Dict[str, float]]:
        """Every rank's `STATS` entries ``names`` (NaN where unset)."""
        names = list(names)
        with self._lock:
            own = _stats_vector(names)
            if self.size > 1:
                data = pickle.dumps(names)
                self._send(OP_STATS_QUERY, 0, (len(data),), None,
                           count=False)
                COUNTS["broadcast_data"] -= 1  # a query, not traffic
                self.broadcast_bytes(data, len(data))
                vecs = self._gather_vec(own)
            else:
                vecs = [own]
            return [dict(zip(names, (float(v) for v in vec)))
                    for vec in vecs]


@atexit.register
def _close_all() -> None:
    for m in list(_LIVE):
        try:
            m.kill()
        except Exception:
            pass


def default_mesh(n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 axis: str = DATA_AXIS, timeout: float = 300.0
                 ) -> ProcessMesh:
    """1-D mesh of ``n_devices`` ranks on ``devices`` (default: the
    first ``n_devices`` CUDA cards; every card when both are None)."""
    if n_devices is None:
        n_devices = len(devices) if devices is not None else max(
            1, torch.cuda.device_count() if torch.cuda.is_available() else 1)
    return ProcessMesh(int(n_devices), devices, axis=axis, timeout=timeout)


def make_mesh(shape: dict, devices: Optional[Sequence] = None,
              timeout: float = 300.0) -> ProcessMesh:
    """A mesh from ``{axis: size}``: one axis in this slice (2-D and
    hybrid meshes are ROADMAP A7)."""
    if len(shape) != 1:
        raise NotImplementedError(
            f"mesh {shape}: only 1-D meshes are ported (2-D and hybrid "
            "meshes are listed under ROADMAP A7)")
    (axis, n), = shape.items()
    return ProcessMesh(int(n), devices, axis=axis, timeout=timeout)
