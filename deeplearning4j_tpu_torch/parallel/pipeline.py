"""Pipeline parallelism: GPipe over a mesh axis — port of
deeplearning4j_tpu/parallel/pipeline.py (JAX :32-154).

Stages live on the ranks of a ``pipe`` axis, one stage a rank (the
driver, rank 0, is stage 0); the block stack is homogeneous (every stage
runs the same ``block_fn`` on an activation of the same shape), its
params stacked [S, ...].

JAX writes the schedule as a `lax.scan` of S + M - 1 ticks of
`ppermute`s inside `shard_map` and lets autodiff reverse it. The port's
schedule is explicit (Huang et al., "GPipe", 2019): stage s runs the
forward of microbatches 0..M-1 in order, each taking its input from
stage s - 1 (stage 0 from the batch) and sending its output to stage
s + 1, keeping each input and output for its backward; the last stage's
outputs reach every rank by one all-reduce, as JAX's ``psum`` does
(:89-91). Under `grad_fn`, the driver takes the loss and its gradient by
the outputs, the last stage receives that gradient, and each stage then
runs `torch.autograd.backward` on its saved microbatches in reverse
order, sending each input's gradient to stage s - 1; the stages' param
gradients come back to the driver stacked [S, ...] (one all-gather).
Nothing is computed in the bubble ticks, where JAX computes on a safe
synthetic input and discards it (:60-65).

``block_fn`` reaches the followers by reference: a module-level function,
imported there by its qualified name. A lambda, a closure or a function
of ``__main__`` raises ValueError. JAX closes over any callable.
``shard_params`` keeps the stacked params on the driver; each call sends
every stage its slice.
"""
from __future__ import annotations

import importlib
import pickle
from typing import Callable, Dict

import numpy as np
import torch

from .mesh import PIPE_AXIS, SERVICE_OPS

Tensor = torch.Tensor

OP_PIPE = SERVICE_OPS
_FACTORY = "deeplearning4j_tpu_torch.parallel.pipeline:_service"


def fn_ref(fn: Callable, what: str) -> str:
    """``module:qualname`` of a module-level function importable by that
    name, or ValueError."""
    mod = getattr(fn, "__module__", None)
    name = getattr(fn, "__qualname__", "")
    ok = mod not in (None, "__main__") and "<" not in name
    if ok:
        try:
            obj = importlib.import_module(mod)
            for part in name.split("."):
                obj = getattr(obj, part)
            ok = obj is fn
        except (ImportError, AttributeError):
            ok = False
    if not ok:
        raise ValueError(
            f"{what} must be a module-level function, importable by its "
            f"qualified name (module:name), so that the mesh's follower "
            f"processes can load it; got {fn!r} (a lambda, a closure or a "
            "function of __main__ cannot reach them)")
    return f"{mod}:{name}"


def load_fn(ref: str) -> Callable:
    mod, name = ref.split(":")
    obj = importlib.import_module(mod)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def stack_block_params(params_list) -> Dict[str, Tensor]:
    """Stack per-stage param dicts into one dict of [S, ...] tensors."""
    keys = list(params_list[0])
    return {k: torch.stack([torch.as_tensor(np.asarray(p[k]))
                            if not isinstance(p[k], Tensor) else p[k]
                            for p in params_list]) for k in keys}


def _flat(params: Dict[str, Tensor]) -> Tensor:
    return torch.cat([params[k].reshape(-1) for k in sorted(params)])


def _unflat(flat: Tensor, shapes) -> Dict[str, Tensor]:
    out, off = {}, 0
    for k in sorted(shapes):
        n = int(np.prod(shapes[k])) if shapes[k] else 1
        out[k] = flat[off:off + n].view(shapes[k])
        off += n
    return out


def _stage(comm, meta, stacked=None, xs=None, dys_of=None):
    """Stage s's part of one call: its params, the forward of the M
    microbatches, the outputs all-reduced to every rank of the group; with
    ``meta["grad"]`` then the reverse-order backward (the driver's
    ``dys_of(ys)``: the loss's gradient by the outputs) and the stacked
    param gradients gathered. Returns (ys, grads or None) on the
    driver."""
    if not comm.on_axis_of_rank0(meta["axis"]):
        return None
    ac = comm.axis_comm(meta["axis"])
    s, S, M = ac.rank, ac.size, meta["n_micro"]
    dt = getattr(torch, meta["dtype"])
    dev = comm.device
    shapes = meta["param_shapes"]
    n_par = sum(int(np.prod(v)) if v else 1 for v in shapes.values())
    if s == 0:
        for r in range(1, S):
            ac.send(_flat({k: v[r] for k, v in stacked.items()}), r)
        flat = _flat({k: v[0] for k, v in stacked.items()})
    else:
        flat = ac.recv((n_par,), dt, 0, device=dev)
    grad = meta["grad"]
    params = {k: v.detach().clone().requires_grad_(grad)
              for k, v in _unflat(flat, shapes).items()}
    fn = load_fn(meta["block"])
    mshape = tuple(meta["micro_shape"])
    saved = []
    ys = torch.zeros((M,) + mshape, dtype=dt, device=dev)
    with torch.set_grad_enabled(grad):
        for m in range(M):
            x = xs[m] if s == 0 else ac.recv(mshape, dt, s - 1, device=dev)
            x = x.detach().requires_grad_(grad and s > 0)
            y = fn(params, x)
            saved.append((x, y))
            if s < S - 1:
                ac.send(y.detach(), s + 1)
            else:
                ys[m] = y.detach()
    # the last stage's outputs to every stage (JAX's psum)
    ys = ac.all_reduce(ys)
    if not grad:
        return ys, None
    dys = dys_of(ys) if s == 0 else None
    if s == 0 and S > 1:
        ac.send(dys, S - 1)
    if s == S - 1:
        g_out = dys if S == 1 else ac.recv((M,) + mshape, dt, 0, device=dev)
    for m in reversed(range(M)):
        x, y = saved[m]
        g = g_out[m] if s == S - 1 else ac.recv(mshape, dt, s + 1,
                                               device=dev)
        torch.autograd.backward(y, g)
        if s > 0:
            ac.send(x.grad, s - 1)
    gflat = _flat({k: (p.grad if p.grad is not None
                       else torch.zeros_like(p))
                   for k, p in params.items()})
    got = ac.all_gather(gflat.unsqueeze(0), 0)  # [S, n_par]
    grads = {k: torch.stack([_unflat(got[r], shapes)[k] for r in range(S)])
             for k in shapes}
    return ys, grads


class _Service:
    def __init__(self, comm, payload):
        self.comm = comm

    def handle(self, cmd) -> None:
        meta = pickle.loads(self.comm.broadcast_bytes(None, cmd.args[0]))
        _stage(self.comm, meta)


def _service(comm, payload) -> _Service:
    return _Service(comm, payload)


class GPipeExecutor:
    """Pipelined apply/train over a homogeneous block stack (see the
    module docstring). ``block_fn(params, x) -> y`` keeps x's shape; the
    params are stacked [S, ...], one stage a rank of ``mesh``'s ``axis``
    (a `parallel.mesh.ProcessMesh`, started at the first call)."""

    def __init__(self, block_fn: Callable, n_stages: int, n_micro: int,
                 mesh, axis: str = PIPE_AXIS):
        if mesh.shape[axis] != n_stages:
            raise ValueError(f"mesh axis {axis!r} has {mesh.shape[axis]} "
                             f"devices, need n_stages={n_stages}")
        self.block_ref = fn_ref(block_fn, "block_fn")
        self.block_fn = block_fn
        self.n_stages = n_stages
        self.n_micro = n_micro
        self.mesh = mesh
        self.axis = axis

    def shard_params(self, stacked_params) -> Dict[str, Tensor]:
        """The stacked [S, ...] params as tensors on the driver's device;
        each call sends every stage its slice."""
        out = {}
        for k, a in stacked_params.items():
            t = a if isinstance(a, Tensor) else torch.as_tensor(np.asarray(a))
            if t.shape[0] != self.n_stages:
                raise ValueError(f"param {k!r} stacks {t.shape[0]} stages, "
                                 f"need {self.n_stages}")
            out[k] = t.to(self.mesh.device)
        return out

    def _split(self, x, microbatch: bool) -> Tensor:
        x = x if isinstance(x, Tensor) else torch.as_tensor(np.asarray(x))
        x = x.to(self.mesh.device)
        if microbatch:
            B = x.shape[0]
            if B % self.n_micro:
                raise ValueError(f"batch {B} not divisible by "
                                 f"n_micro={self.n_micro}")
            return x.reshape((self.n_micro, B // self.n_micro)
                             + tuple(x.shape[1:]))
        if x.shape[0] != self.n_micro:
            raise ValueError(
                f"pre-split input has {x.shape[0]} microbatches; "
                f"executor was built with n_micro={self.n_micro}")
        return x

    def _call(self, stacked, xs, grad: bool, dys_of=None):
        stacked = self.shard_params(stacked)
        meta = {"axis": self.axis, "n_micro": self.n_micro, "grad": grad,
                "block": self.block_ref,
                "dtype": str(xs.dtype).split(".")[-1],
                "micro_shape": tuple(xs.shape[1:]),
                "param_shapes": {k: tuple(v.shape[1:])
                                 for k, v in stacked.items()}}
        self.mesh.start()
        return self.mesh.run_service(
            _FACTORY, OP_PIPE, meta,
            lambda: _stage(self.mesh, meta, stacked, xs, dys_of))

    def apply(self, stacked_params, x, *, microbatch: bool = True) -> Tensor:
        """Run the stack over x ([B, ...], or pre-split [M, b, ...] with
        ``microbatch=False``)."""
        xs = self._split(x, microbatch)
        with torch.no_grad():
            ys, _ = self._call(stacked_params, xs, False)
        return ys.reshape((-1,) + tuple(ys.shape[2:])) if microbatch else ys

    def grad_fn(self, loss_fn: Callable):
        """``f(stacked, x, target) -> (loss, grads)``: d loss_fn(y, target)
        / d(stacked params) through the pipeline (see the module
        docstring); ``loss_fn`` runs on the driver only."""

        def value_and_grad(stacked_params, x, target):
            xs = self._split(x, True)
            t = target if isinstance(target, Tensor) else torch.as_tensor(
                np.asarray(target))
            t = t.to(self.mesh.device)
            loss = []

            def dys_of(ys):
                with torch.enable_grad():
                    y = ys.reshape((-1,) + tuple(ys.shape[2:])).detach() \
                        .requires_grad_(True)
                    value = loss_fn(y, t)
                    (gy,) = torch.autograd.grad(value, y)
                loss.append(value.detach())
                return gy.reshape(ys.shape).contiguous()

            _, grads = self._call(stacked_params, xs, True, dys_of)
            return loss[0], grads

        return value_and_grad
