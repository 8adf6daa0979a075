"""Captured training steps: the port's counterpart of the JAX train step's
one compiled program (nn/multilayer.py `_get_train_step`, graph.py
:367), shared by MultiLayerNetwork and ComputationGraph.

A facade keeps one step body: forward, backward and the update, written
into the net's own tensors in place, its step-dependent scalars read from
the device row `StepGraphs.set_row` fills. On the CPU, or with
``train_graphs="off"``, `StepGraphs.run` calls the body directly. On the
card it runs the body once per key (the shapes, dtypes and presence of
every argument, and the facade's tag) eagerly on a side stream — that run
is the step itself and the warm-up capture needs — then captures the
body into a CUDA graph in the net's one graph pool, and replays that
graph for every later step of the key. The arguments are copied into the
graph's static buffers first; the outputs are copied out after.

The kernel launches of the capture are taken back out of
``cuda_kernels.LAUNCHES`` (and the bf16 BN+act+pool route counts) and
added again on every replay, so a replay counts what the eager step
counts. The net's dropout generator is registered with every graph, so a
replay draws what the eager step would draw. A capture that fails raises;
nothing falls back to the eager step. The graphs hold the addresses of
the tensors they were captured on: a run that finds the net's tensors
replaced (not copied into) drops every graph and captures again.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import cuda_kernels as ck

Tensor = torch.Tensor
TRAIN_GRAPHS = ("on", "off")
SGD_ALGOS = ("stochastic_gradient_descent", "sgd")


def algo_of(gconf) -> str:
    """A config's ``optimization_algo``, lower case (SGD when unset)."""
    return (gconf.optimization_algo or "stochastic_gradient_descent").lower()


def resolve_train_graphs(mode: Optional[str]) -> str:
    mode = "on" if mode is None else str(mode).lower()
    if mode not in TRAIN_GRAPHS:
        raise ValueError(f"train_graphs={mode!r}: expected one of "
                         f"{TRAIN_GRAPHS}")
    return mode


def to_device(a, device: torch.device, float_dtype) -> Optional[Tensor]:
    """``a`` (numpy, a tensor or None) on ``device``, floats at
    ``float_dtype``. A host array bound for the card is staged through
    pinned memory and copied without a host sync (the caching host
    allocator keeps the pinned block until the copy has run)."""
    if a is None:
        return None
    t = a if isinstance(a, Tensor) else torch.as_tensor(np.asarray(a))
    if device.type == "cuda" and t.device.type == "cpu":
        if not t.is_pinned():
            t = t.pin_memory()
        t = t.to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t.to(float_dtype) if t.is_floating_point() else t


def stack_on(arrays, device, dtype) -> Optional[Tensor]:
    """A [K, ...] stack on ``device``: one array or tensor, or a list of
    K (pinned batches from the prefetching iterator are copied without a
    host sync)."""
    if arrays is None:
        return None
    if not isinstance(arrays, (list, tuple)):
        return to_device(arrays, device, dtype)
    if all(isinstance(a, Tensor) for a in arrays):
        out = torch.empty((len(arrays),) + tuple(arrays[0].shape),
                          dtype=dtype if arrays[0].is_floating_point()
                          else arrays[0].dtype, device=device)
        for j, a in enumerate(arrays):
            out[j].copy_(a, non_blocking=True)
        return out
    return to_device(np.stack([np.asarray(a) for a in arrays]), device,
                     dtype)


@torch.no_grad()
def copy_into(dst, src) -> None:
    """Copy ``src`` into the tensors of ``dst`` (the same nesting of
    lists and dicts), in place: what replaces a net's params, variables or
    updater state keeps the addresses its captured steps write."""
    if isinstance(dst, Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            copy_into(v, src[k])
    else:
        for d, s_ in zip(dst, src):
            copy_into(d, s_)


@contextlib.contextmanager
def gc_paused():
    """No automatic garbage collection inside: a collection during a
    capture may free another, unreachable CUDA graph, and destroying a
    graph is a call a capture forbids (it invalidates the capture)."""
    on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if on:
            gc.enable()


def _flatten(obj, leaves: List[Tensor]):
    """The tensors of nested lists, tuples and dicts, appended to
    ``leaves`` in order; returns the structure's signature (shapes and
    dtypes included, None kept as a hole)."""
    if obj is None:
        return None
    if isinstance(obj, Tensor):
        leaves.append(obj)
        return ("T", tuple(obj.shape), obj.dtype)
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, tuple(_flatten(o, leaves) for o in obj))
    if isinstance(obj, dict):
        return ("d", tuple((k, _flatten(v, leaves)) for k, v in obj.items()))
    raise TypeError(f"step argument of type {type(obj).__name__}")


def _rebuild(sig, it):
    if sig is None:
        return None
    tag = sig[0]
    if tag == "T":
        return next(it)
    if tag == "d":
        return {k: _rebuild(s, it) for k, s in sig[1]}
    seq = [_rebuild(s, it) for s in sig[1]]
    return seq if tag == "list" else tuple(seq)


def _map(obj, fn):
    if isinstance(obj, Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _map(v, fn) for k, v in obj.items()}
    return obj


_SIDE_STREAMS: Dict[torch.device, Any] = {}


def _side_stream(device: torch.device):
    s = _SIDE_STREAMS.get(device)
    if s is None:
        s = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return s


def _counters():
    return (dict(ck.LAUNCHES), dict(ck.BNAP_BF16_ROUTES))


class _StepRunner:
    """One key's static argument buffers, its graph, the graph's outputs
    and the launches (and bf16 BN+act+pool routes) one replay makes."""

    def __init__(self, sig, leaves: Sequence[Tensor]):
        self.sig = sig
        self.static = [torch.empty(tuple(t.shape), dtype=t.dtype,
                                   device=t.device) for t in leaves]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None
        self.launches: Dict[str, int] = {}
        self.routes: Dict[str, int] = {}

    def fill(self, leaves: Sequence[Tensor]) -> None:
        for s, t in zip(self.static, leaves):
            s.copy_(t, non_blocking=True)

    def args(self):
        return _rebuild(self.sig, iter(self.static))


class StepGraphs:
    """A net's step scalars on the device and its captured steps (see the
    module docstring). ``mode`` is the facade's ``train_graphs``; graphs
    exist only on a CUDA device with mode "on". ``captures`` and
    ``replays`` count what happened over the net's life."""

    def __init__(self, device: torch.device, mode: str,
                 row_dtype=torch.float32):
        self.device = device
        self.mode = resolve_train_graphs(mode)
        self.row_dtype = row_dtype
        self.capturing = self.mode == "on" and device.type == "cuda"
        self.row: Optional[Tensor] = None
        self.row_views: List[Tensor] = []
        self._pool = None
        self._runners: Dict[Any, _StepRunner] = {}
        self._bound: Optional[tuple] = None
        self.captures = 0
        self.replays = 0

    def drop(self) -> None:
        """Forget every graph (and the pool their memory came from)."""
        self._runners.clear()
        self._bound = None
        self._pool = None

    # -- the step's scalars ---------------------------------------------------
    def rows(self, values) -> Tensor:
        """Host rows of scalars (one row, or K rows of K steps) on the
        device at ``row_dtype``, in one copy."""
        np_dtype = np.float64 if self.row_dtype == torch.float64 \
            else np.float32
        return to_device(np.asarray(values, np_dtype), self.device,
                         self.row_dtype)

    def set_row(self, values) -> None:
        """Write the step's scalars into the device row the body reads:
        ``values`` host values (staged through pinned memory) or one of
        `rows`' rows (copied device to device). A row of another length
        is a new row, and drops the graphs."""
        if not isinstance(values, Tensor):
            values = self.rows(values)
        n = int(values.shape[0])
        if self.row is None or self.row.shape[0] != n:
            self.drop()
            self.row = torch.zeros(n, dtype=self.row_dtype,
                                   device=self.device)
            self.row_views = list(self.row.unbind(0))
        self.row.copy_(values, non_blocking=True)

    # -- the step -------------------------------------------------------------
    def run(self, tag, args, body: Callable, state: Sequence[Tensor],
            generator: Optional[torch.Generator] = None):
        """``body(*args)`` as one step, eagerly or by replay; returns its
        outputs as fresh tensors. ``state`` lists the net's tensors the
        body reads and writes in place (params, variables, updater
        state), ``generator`` the one its dropout draws from."""
        if not self.capturing:
            return body(*args)
        leaves: List[Tensor] = []
        sig = _flatten(args, leaves)
        ids = tuple(map(id, state))
        if self._bound is not None and self._bound[0] != ids:
            self.drop()
        key = (tag, sig)
        r = self._runners.get(key)
        if r is None:
            return self._first(key, sig, leaves, body, state, ids, generator)
        r.fill(leaves)
        r.graph.replay()
        for k, n in r.launches.items():
            ck.LAUNCHES[k] += n
        for k, n in r.routes.items():
            ck.BNAP_BF16_ROUTES[k] += n
        self.replays += 1
        return _map(r.out, torch.clone)

    def _first(self, key, sig, leaves, body, state, ids, generator):
        """The key's first step: run eagerly on the side stream, then
        captured (which runs nothing)."""
        dev = self.device
        r = _StepRunner(sig, leaves)
        r.fill(leaves)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(dev)
        s = _side_stream(dev)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            out = body(*r.args())
        mark = _counters()
        g = torch.cuda.CUDAGraph()
        if generator is not None and generator.device.type == "cuda":
            g.register_generator_state(generator)
        try:
            with gc_paused(), torch.cuda.stream(s):
                g.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
                try:
                    r.out = body(*r.args())
                except BaseException:
                    try:
                        g.capture_end()
                    except Exception:  # the body's error is the one to see
                        pass
                    raise
                g.capture_end()
        except Exception as e:
            raise RuntimeError(f"capturing the train step {key[0]!r} "
                               f"failed: {e}") from e
        finally:
            cur.wait_stream(s)
            now = _counters()
            ck.LAUNCHES.update(mark[0])
            ck.BNAP_BF16_ROUTES.update(mark[1])
        r.launches = {k: now[0][k] - mark[0][k] for k in now[0]
                      if now[0][k] != mark[0][k]}
        r.routes = {k: now[1][k] - mark[1][k] for k in now[1]
                    if now[1][k] != mark[1][k]}
        r.graph = g
        self._runners[key] = r
        # the graphs write into these tensors: keep them alive with them
        self._bound = (ids, list(state))
        self.captures += 1

        def on_cur(t):
            t.record_stream(cur)
            return t
        return _map(out, on_cur)
