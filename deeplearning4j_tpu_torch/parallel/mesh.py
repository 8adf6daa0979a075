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
``broadcast_data``, and the point-to-point and exchange collectives
``send``, ``recv`` and ``all_to_all``, like `ops.cuda_kernels.LAUNCHES`
counts kernel launches (`inference/sharding.collective_counts` reads
them). A collective on an axis communicator is also counted as
``"<kind>@<axis>"`` (a 1-D mesh's own collectives under its axis).

A follower that dies makes the driver's next collective raise (gloo
reports the closed connection at once), and the driver checks that every
follower is alive before each command; the caller (the decode engine, a
training master) turns that into its own failure. An idle driver sends a
no-op command every quarter of the group's ``timeout`` so that a
follower's wait never times out. A size-1 mesh starts no process: its
collectives are no-ops.

Axis names follow the JAX package: "data" (data parallelism), "model"
(tensor parallelism in training), "seq", "pipe", "expert", and the
decode engine's "tp" (`inference/sharding.TP_AXIS`).

Meshes of more than one axis (`make_mesh`, `mesh_2d`, `hybrid_mesh`):
the ranks lie in row-major order over the axes, as JAX reshapes
``devices[:total]`` (JAX mesh.py :45-53), so rank r sits at
``np.unravel_index(r, shape)``. The geometry is known before `start()`.
Each axis has a communicator (`axis_comm(axis)`): the ranks that share
every other coordinate with this one, as a process group of their own,
gloo or NCCL by `backend_for` over the group's devices, rendezvousing
through a `PrefixStore` of the mesh's `FileStore`. Every rank builds its
groups at start, axis by axis in the mesh's axis order, so the
rendezvous cannot hang. A 1-D mesh's axis communicator is the mesh.

Routes of the exchange collectives. ``send`` / ``recv`` / ``exchange``
and ``all_to_all`` run on the group's own tensors under NCCL (a CPU
tensor travels through the rank's card); under gloo a CUDA tensor is
staged through a host copy (gloo's point-to-point and all-to-all move
host memory), as `broadcast_data` stages a CPU tensor under NCCL.
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
#: the point-to-point and exchange collectives (GPipe, ring attention,
#: MoE), counted beside those
EXCHANGE_KINDS = ("send", "recv", "all_to_all")
ALL_KINDS = COLLECTIVE_KINDS + EXCHANGE_KINDS

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


def _pg_on(store, rank: int, size: int, backend: str, timeout: float):
    import torch.distributed as dist
    td = datetime.timedelta(seconds=float(timeout))
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = td
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    return dist.ProcessGroupGloo(store, rank, size, td)


def _make_pg(path: str, rank: int, size: int, backend: str,
             timeout: float):
    """(the mesh's process group, its store)."""
    import torch.distributed as dist
    store = dist.FileStore(path, size)
    return _pg_on(store, rank, size, backend, timeout), store


def _grid(shape: Dict[str, int]) -> np.ndarray:
    return np.arange(int(np.prod(list(shape.values())))).reshape(
        [int(v) for v in shape.values()])


def axis_group(shape: Dict[str, int], axis: str, rank: int) -> List[int]:
    """The ranks of ``rank``'s group on ``axis``: those that share every
    other coordinate with it, in order along the axis."""
    names = list(shape)
    d = names.index(axis)
    grid = _grid(shape)
    idx = list(np.unravel_index(rank, grid.shape))
    idx[d] = slice(None)
    return [int(r) for r in grid[tuple(idx)]]


def _make_axis_comms(store, rank: int, shape: Dict[str, int], devices,
                     timeout: float) -> Dict[str, "_AxisComm"]:
    """This rank's communicator on every axis of a mesh of more than one
    axis, built axis by axis in the mesh's order (every rank the same
    order), each over a `PrefixStore` of the mesh's store."""
    import torch.distributed as dist
    out: Dict[str, _AxisComm] = {}
    if len(shape) < 2:
        return out
    for axis in shape:
        ranks = axis_group(shape, axis, rank)
        backend = backend_for([devices[r] for r in ranks])
        prefix = f"axis/{axis}/" + "-".join(str(r) for r in ranks)
        pg = _pg_on(dist.PrefixStore(prefix, store), ranks.index(rank),
                    len(ranks), backend, timeout)
        out[axis] = _AxisComm(pg, axis, ranks, rank, devices[rank], backend)
    return out


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
    #: the axis this communicator's collectives are also counted under
    axis_label: Optional[str] = None

    def _count(self, kind: str) -> None:
        COUNTS[kind] += 1
        if self.axis_label is not None:
            COUNTS[f"{kind}@{self.axis_label}"] += 1

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        if self.size == 1:
            return t
        self._count("all_reduce")
        self._pg.allreduce([t]).wait()
        return t

    # -- point to point and exchanges (see the module docstring's routes) --
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend moves it: on the rank's card under NCCL,
        in host memory under gloo."""
        t = t.contiguous()
        if self.backend == "nccl":
            return t if t.device.type == "cuda" else t.to(self.device)
        return t if t.device.type == "cpu" else t.cpu()

    def send(self, t: torch.Tensor, dst: int, tag: int = 0) -> None:
        """Send ``t`` to rank ``dst`` of this communicator."""
        self._count("send")
        self._pg.send([self._wire(t)], int(dst), tag).wait()

    def recv(self, shape, dtype, src: int, device=None,
             tag: int = 0) -> torch.Tensor:
        """A tensor of ``shape`` / ``dtype`` from rank ``src``, on
        ``device`` (default this rank's)."""
        self._count("recv")
        dev = self.device if device is None else torch.device(device)
        buf = torch.empty(tuple(shape), dtype=dtype,
                          device=self.device if self.backend == "nccl"
                          else "cpu")
        self._pg.recv([buf], int(src), tag).wait()
        return buf.to(dev)

    def exchange(self, t: torch.Tensor, dst: int, src: int,
                 tag: int = 0) -> torch.Tensor:
        """Send ``t`` to ``dst`` and receive a tensor of its shape from
        ``src`` at once (a ring's rotation): one ``send`` and one
        ``recv``. Under NCCL the even ranks send first, so that a ring
        of blocking sends never waits on itself."""
        self._count("send")
        self._count("recv")
        out = self._wire(t)
        buf = torch.empty_like(out)
        if self.backend == "nccl" and self.rank % 2:
            self._pg.recv([buf], int(src), tag).wait()
            self._pg.send([out], int(dst), tag).wait()
        else:
            w = self._pg.send([out], int(dst), tag)
            self._pg.recv([buf], int(src), tag).wait()
            w.wait()
        return buf.to(t.device)

    def all_to_all(self, t: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """JAX's tiled ``all_to_all``: ``t`` cut into ``size`` chunks
        along ``split_dim``, chunk j to rank j, and the chunks received
        from ranks 0..n-1 concatenated along ``concat_dim``, on ``t``'s
        device."""
        if self.size == 1:
            return t
        self._count("all_to_all")
        n = self.size
        if t.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of size "
                             f"{t.shape[split_dim]} does not split into "
                             f"{n} ranks")
        inp = self._wire(torch.stack(t.chunk(n, split_dim)))
        out = torch.empty_like(inp)
        self._pg.alltoall_base(out, inp, [], []).wait()
        return torch.cat(out.unbind(0), dim=concat_dim).to(t.device)

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated along the last axis, rank order."""
        return self.all_gather(t, -1)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim``, rank order, on
        ``t``'s device (a CPU tensor under NCCL travels through the
        rank's card)."""
        if self.size == 1:
            return t
        self._count("all_gather")
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
        self._count("broadcast_data")
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

    def _count_keys(self, by_axis: bool) -> List[str]:
        if not by_axis:
            return list(COLLECTIVE_KINDS)
        return list(ALL_KINDS) + [f"{k}@{a}" for a in self.axis_names
                                  for k in ALL_KINDS]

    def _counts_vector(self, by_axis: bool = False) -> torch.Tensor:
        return torch.tensor([COUNTS[k] for k in self._count_keys(by_axis)],
                            dtype=torch.int64)

    def _gather_counts(self, own: torch.Tensor,
                       by_axis: bool = False) -> List[Dict[str, int]]:
        keys = self._count_keys(by_axis)
        return [dict(zip(keys, (int(v) for v in o)))
                for o in self._gather_vec(own)]

    # -- geometry ----------------------------------------------------------
    axis_names: tuple = ()
    shape: Dict[str, int] = {}
    _axis_comms: Dict[str, "_AxisComm"] = {}

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Rank ``rank``'s (default this rank's) coordinate on each axis."""
        r = self.rank if rank is None else int(rank)
        idx = np.unravel_index(r, [self.shape[a] for a in self.axis_names])
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def on_axis_of_rank0(self, axis: str) -> bool:
        """Whether this rank shares rank 0's coordinates off ``axis``: the
        group on ``axis`` that the driver's work (ring attention, GPipe,
        MoE) runs on; the other groups sit it out."""
        return all(v == 0 for a, v in self.coords().items() if a != axis)

    def axis_comm(self, axis: str) -> "_Comm":
        """This rank's communicator on ``axis`` (see the module
        docstring); a 1-D mesh is its own axis communicator."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r} (axes: "
                             f"{self.axis_names})")
        if len(self.axis_names) == 1:
            return self
        comm = self._axis_comms.get(axis)
        if comm is None:
            if self.size == 1 or self.shape[axis] == 1:
                return _AxisComm(None, axis, [self.rank], self.rank,
                                 self.device, self.backend)
            raise MeshError("the mesh is not started (or was killed)")
        return comm


class _AxisComm(_Comm):
    """One rank's communicator on one axis of a mesh: ``rank`` is its
    coordinate on the axis, ``size`` the axis size, ``ranks`` the group's
    mesh ranks; every collective is also counted as ``"<kind>@<axis>"``."""

    def __init__(self, pg, axis: str, ranks: List[int], mesh_rank: int,
                 device: torch.device, backend: str):
        self._pg = pg
        self.axis_label = axis
        self.ranks = list(ranks)
        self.rank = self.ranks.index(mesh_rank)
        self.size = len(self.ranks)
        self.device = device
        self.backend = backend


class _Follower(_Comm):
    """Rank r > 0 inside its own process: receives commands."""

    def __init__(self, pg, rank, size, device, backend, cmd_len,
                 shape=None, axis_comms=None):
        self._pg = pg
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self._cmd_len = cmd_len
        self.shape = dict(shape or {})
        self.axis_names = tuple(self.shape)
        self.axis_label = (self.axis_names[0]
                           if len(self.axis_names) == 1 else None)
        self._axis_comms = dict(axis_comms or {})

    def recv_command(self) -> Command:
        buf = torch.zeros(self._cmd_len, dtype=torch.int32)
        if self.backend == "nccl":
            buf = buf.to(self.device)
        self._pg.broadcast(buf, 0).wait()
        self._count("broadcast_command")
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
                   flags: Dict[str, bool], shape: Dict[str, int],
                   devices: List[str]) -> None:
    """A follower process: join the group, then execute commands until
    ``STOP``. A service that raises ends the process (the driver's next
    collective then fails), after printing the traceback."""
    set_backend_flags(flags)
    dev = _norm_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    pg, store = _make_pg(store_path, rank, size, backend, timeout)
    comms = _make_axis_comms(store, rank, shape,
                             [_norm_device(d) for d in devices], timeout)
    me = _Follower(pg, rank, size, dev, backend, cmd_len, shape, comms)
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
                by_axis = bool(cmd.args[0])
                own = me._counts_vector(by_axis)
                # the query's own command broadcast is not part of what
                # was measured
                keys = me._count_keys(by_axis)
                for k in ("broadcast_command",
                          f"broadcast_command@{me.axis_label}"):
                    if k in keys:
                        own[keys.index(k)] -= 1
                me._gather_counts(own, by_axis)
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
    """A mesh of ``n`` ranks over ``devices`` (one a rank; rank 0 is this
    process, on ``devices[0]``): 1-D over ``axis``, or over the axes of
    ``shape`` (``{axis: size}``, whose sizes multiply to ``n``; ranks in
    row-major order). Default devices: ``cuda:0`` .. ``cuda:n-1``, which
    raises when the machine has fewer cards; ranks sharing a card
    (``["cuda:0"] * n``) and CPU ranks (``["cpu"] * n``) are the caller's
    explicit choice. ``timeout`` (seconds): the process group's timeout,
    for the rendezvous and every collective.

    The followers start at the first `start()` (an engine or a master
    starts the mesh it is given), and again after `kill()` or a dead
    follower; `close()` stops them. ``shape`` and ``axis_names`` read as
    a JAX mesh's do; `rank_grid` is the ranks laid out on the axes, as a
    JAX mesh's ``devices`` array."""

    def __init__(self, n: int, devices: Optional[Sequence] = None,
                 axis: str = DATA_AXIS, timeout: float = 300.0,
                 shape: Optional[Dict[str, int]] = None):
        n = int(n)
        if n < 1:
            raise ValueError(f"a mesh needs >= 1 rank, got {n}")
        if shape is None:
            shape = {axis: n}
        shape = {str(a): int(v) for a, v in shape.items()}
        if int(np.prod(list(shape.values()))) != n:
            raise ValueError(f"mesh shape {shape} does not hold {n} ranks")
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
        self.axis_names = tuple(shape)
        self.shape = shape
        self.axis_label = (self.axis_names[0]
                           if len(self.axis_names) == 1 else None)
        self._axis_comms = {}
        self._store = None
        self.backend = backend_for(devs)
        self.timeout = float(timeout)
        self._pg = None
        self._procs: List[Any] = []
        self._dir: Optional[str] = None
        self._cmd_len = _DEFAULT_CMD
        self._lock = threading.RLock()
        self._last = time.monotonic()
        self._next_service = 1
        self._services: Dict[str, tuple] = {}
        self._keepalive: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self.starts = 0  # times the followers were started

    @property
    def rank_grid(self) -> np.ndarray:
        """The mesh's ranks laid out on its axes (row-major)."""
        return _grid(self.shape)

    def axis_groups(self, axis: str) -> List[List[int]]:
        """The groups of ``axis``: one rank list per fixed position of
        the other axes, in order along the axis."""
        grid = np.moveaxis(self.rank_grid, self.axis_names.index(axis), -1)
        return [[int(r) for r in row]
                for row in grid.reshape(-1, self.shape[axis])]

    def __repr__(self) -> str:
        return (f"ProcessMesh({dict(self.shape)}, devices="
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
                      self.timeout, self._cmd_len, backend_flags(),
                      dict(self.shape), [str(d) for d in self.devices]),
                daemon=True)
                for r in range(1, self.size)]
            for p in self._procs:
                p.start()
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                self._pg, self._store = _make_pg(path, 0, self.size,
                                                 self.backend, self.timeout)
                self._axis_comms = _make_axis_comms(
                    self._store, 0, self.shape, self.devices, self.timeout)
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
            self._axis_comms = {}
            self._store = None
            self._services = {}
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
            self._count("broadcast_command")
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

    def service(self, factory: str, payload: Any = None) -> int:
        """The id of a service built from ``factory`` on the followers of
        the running mesh, attached at its first request (with
        ``payload``) and kept until the followers stop: the shared
        services of `ring`, `pipeline` and `moe`, whose work comes with
        each command."""
        with self._lock:
            self.start()
            got = self._services.get(factory)
            if got is not None and got[1] == self.starts:
                return got[0]
            sid = self.attach(factory, payload)
            self._services[factory] = (sid, self.starts)
            return sid

    def run_service(self, factory: str, op: int, data: Any,
                    fn: Callable[[], Any]) -> Any:
        """One piece of work on every rank: the command ``op`` to the
        followers' shared service ``factory`` (`service`) with ``data``
        (one data broadcast of its pickle), then ``fn()`` here. A size-1
        mesh just runs ``fn()``."""
        if self.size == 1:
            return fn()
        with self._lock:
            sid = self.service(factory)
            blob = pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)
            self.command(op, sid, (len(blob),))
            self.broadcast_bytes(blob, len(blob))
            return fn()

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

    def query_counts(self, by_axis: bool = False) -> List[Dict[str, int]]:
        """Every rank's `COUNTS` (rank order), as they stood before this
        query: the four kinds of `COLLECTIVE_KINDS`, or with ``by_axis``
        every kind and every ``"<kind>@<axis>"`` of the mesh's axes."""
        with self._lock:
            own = self._counts_vector(by_axis)
            if self.size == 1:
                return [dict(zip(self._count_keys(by_axis),
                                 (int(v) for v in own)))]
            self._send(OP_COUNTS_QUERY, 0, (int(by_axis),), None,
                       count=False)
            return self._gather_counts(own, by_axis)


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
                # a query, not traffic
                COUNTS["broadcast_data"] -= 1
                if self.axis_label is not None:
                    COUNTS[f"broadcast_data@{self.axis_label}"] -= 1
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
    """A mesh from ``{axis: size}`` (JAX :45-53): the sizes multiply to
    the rank count, the ranks in row-major order over the axes; default
    devices ``cuda:0`` .. ``cuda:n-1`` (see `ProcessMesh`)."""
    if not shape:
        raise ValueError("a mesh needs at least one axis")
    sizes = {str(a): int(v) for a, v in shape.items()}
    if any(v < 1 for v in sizes.values()):
        raise ValueError(f"mesh {shape}: every axis needs >= 1 rank")
    n = int(np.prod(list(sizes.values())))
    if len(sizes) == 1:
        (axis, _), = sizes.items()
        return ProcessMesh(n, devices, axis=axis, timeout=timeout)
    return ProcessMesh(n, devices, timeout=timeout, shape=sizes)


def mesh_2d(data: int, model: int,
            axes: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
            devices: Optional[Sequence] = None,
            timeout: float = 300.0) -> ProcessMesh:
    """A ``data`` x ``model`` mesh (JAX :35-42)."""
    a, b = axes
    return make_mesh({a: int(data), b: int(model)}, devices, timeout)


def hybrid_mesh(dcn_shape: dict, ici_shape: dict,
                devices: Optional[Sequence] = None,
                timeout: float = 300.0) -> ProcessMesh:
    """A multi-slice mesh (JAX :56-111): the ``dcn_shape`` axes outermost
    (across slices), the ``ici_shape`` axes within one. Axis names must
    be unique across both; the geometry must fit ``devices`` (default:
    the machine's cards, or the CPU ranks of ``devices``). One host is one
    slice, so contiguous blocks of ``prod(ici_shape)`` ranks stand in for
    the slices (JAX's pseudo-slice branch), with JAX's warning when more
    than one slice is asked for."""
    dcn_axes, ici_axes = tuple(dcn_shape), tuple(ici_shape)
    overlap = set(dcn_axes) & set(ici_axes)
    if overlap:
        raise ValueError(f"axis names must be unique across dcn/ici: "
                         f"{overlap}")
    n_slices = int(np.prod([int(s) for s in dcn_shape.values()]))
    per_slice = int(np.prod([int(s) for s in ici_shape.values()]))
    have = (len(devices) if devices is not None else
            (torch.cuda.device_count() if torch.cuda.is_available() else 0))
    if n_slices * per_slice > have:
        raise ValueError(f"hybrid mesh {dcn_shape}x{ici_shape} needs "
                         f"{n_slices * per_slice} devices, have {have}")
    if n_slices > 1:
        import warnings
        warnings.warn(
            f"hybrid_mesh: requested {n_slices} slices but only one "
            f"real slice is present — falling back to pseudo-slice "
            f"contiguous blocks, so the '{'/'.join(dcn_axes)}' DCN "
            f"axis actually rides ICI. Fine for tests; on real "
            f"hardware check the pod topology.", stacklevel=2)
    devs = None if devices is None else list(devices)[:n_slices * per_slice]
    return make_mesh({**dcn_shape, **ici_shape}, devs, timeout)
