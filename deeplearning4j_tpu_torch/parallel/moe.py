"""Expert parallelism: a Mixture-of-Experts layer with all-to-all
dispatch — port of deeplearning4j_tpu/parallel/moe.py (JAX :27-118).

One expert a rank of an ``expert`` axis (the driver, rank 0, holds expert
0), the batch split over the same axis. Each rank (`_moe_local`, the
body of JAX's `moe_spmd_fn`, :44-48) gates its tokens top-1 with the
replicated router, places each in its expert's capacity buffer by JAX's
position rule (a token past the capacity C is dropped: its output is 0),
builds the [E, C, D] expert inputs with einsums (the dense-dispatch
formulation of Mesh-TensorFlow and Switch), sends them to the experts'
ranks with one all-to-all, runs its expert, brings the results home with
a second all-to-all and combines them by the gate. `grad_fn`
differentiates the whole of it on every rank (the all-to-alls are
`tp_autograd.all_to_all`, whose backward is the reverse exchange); the
driver gathers the outputs, takes the loss and hands each rank its rows'
gradient; the experts' gradients come back stacked [E, ...] and the
router's summed over the ranks.

``expert_fn`` reaches the followers by reference, as GPipe's
``block_fn`` does (`pipeline.fn_ref`).
"""
from __future__ import annotations

import pickle
from typing import Callable, Dict

import numpy as np
import torch

from .mesh import EXPERT_AXIS, SERVICE_OPS
from .pipeline import _flat, _unflat, fn_ref, load_fn

Tensor = torch.Tensor

OP_MOE = SERVICE_OPS
_FACTORY = "deeplearning4j_tpu_torch.parallel.moe:_service"


def _moe_local(ac, expert_fn, params, gate_w, x, capacity: int) -> Tensor:
    """One rank's MoE over its [n, D] tokens (JAX `moe_spmd_fn`)."""
    from .tp_autograd import all_to_all
    E, C = ac.size, capacity
    probs = torch.softmax(x @ gate_w, dim=-1)                   # [n, E]
    gate = probs.max(dim=-1).values                             # top-1
    onehot = torch.nn.functional.one_hot(
        probs.argmax(dim=-1), E).to(x.dtype)                    # [n, E]
    # position of each token in its expert's capacity buffer
    pos = torch.cumsum(onehot, dim=0) * onehot - onehot         # [n, E]
    keep = onehot * (pos < C).to(x.dtype)
    dispatch = keep[..., None] * torch.nn.functional.one_hot(
        pos.to(torch.int64).clamp(0, C - 1), C).to(x.dtype)        # [n, E, C]
    expert_in = torch.einsum("nec,nd->ecd", dispatch, x)        # [E, C, D]
    recv = all_to_all(ac, expert_in, 0, 0)                      # [E, C, D]
    out = expert_fn(params, recv.reshape(E * C, -1)).reshape(E, C, -1)
    back = all_to_all(ac, out, 0, 0)
    combine = dispatch * gate[:, None, None]
    return torch.einsum("nec,ecd->nd", combine, back)


def _rank_part(comm, meta, stacked=None, gate_w=None, x=None,
               dy_of=None):
    """Every rank's part of one call: its expert's params, its tokens and
    the router from the driver, the forward (and under ``grad`` the
    backward from its rows' gradient), the outputs gathered, and the
    gradients (experts stacked, router summed). Returns (y, grads)
    on the driver."""
    if not comm.on_axis_of_rank0(meta["axis"]):
        return None
    ac = comm.axis_comm(meta["axis"])
    e, E = ac.rank, ac.size
    dt = getattr(torch, meta["dtype"])
    dev = comm.device
    shapes = meta["param_shapes"]
    n_par = sum(int(np.prod(v)) if v else 1 for v in shapes.values())
    n_local, D = meta["n_local"], meta["d"]
    if e == 0:
        for r in range(1, E):
            ac.send(_flat({k: v[r] for k, v in stacked.items()}), r)
            ac.send(gate_w, r)
            ac.send(x[r * n_local:(r + 1) * n_local], r)
        flat, xl = _flat({k: v[0] for k, v in stacked.items()}), x[:n_local]
    else:
        flat = ac.recv((n_par,), dt, 0, device=dev)
        gate_w = ac.recv(tuple(meta["gate_shape"]), dt, 0, device=dev)
        xl = ac.recv((n_local, D), dt, 0, device=dev)
    grad = meta["grad"]
    params = {k: v.detach().clone().requires_grad_(grad)
              for k, v in _unflat(flat, shapes).items()}
    gw = gate_w.detach().clone().requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        y = _moe_local(ac, load_fn(meta["expert"]), params, gw, xl,
                       meta["capacity"])
    ys = ac.all_gather(y.detach(), 0)
    if not grad:
        return ys, None
    if e == 0:
        dy = dy_of(ys)
        for r in range(1, E):
            ac.send(dy[r * n_local:(r + 1) * n_local], r)
        dy = dy[:n_local]
    else:
        dy = ac.recv((n_local, y.shape[-1]), dt, 0, device=dev)
    torch.autograd.backward(y, dy)
    gflat = _flat({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                   for k, p in params.items()})
    got = ac.all_gather(gflat.unsqueeze(0), 0)
    g_experts = {k: torch.stack([_unflat(got[r], shapes)[k]
                                 for r in range(E)]) for k in shapes}
    g_gate = ac.all_reduce(gw.grad.clone() if gw.grad is not None
                           else torch.zeros_like(gw))
    return ys, (g_experts, g_gate)


class _Service:
    def __init__(self, comm, payload):
        self.comm = comm

    def handle(self, cmd) -> None:
        meta = pickle.loads(self.comm.broadcast_bytes(None, cmd.args[0]))
        _rank_part(self.comm, meta)


def _service(comm, payload) -> _Service:
    return _Service(comm, payload)


def _tensor(a, device) -> Tensor:
    t = a if isinstance(a, Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device)


class MoEExecutor:
    """Expert-parallel MoE layer over a mesh ``expert`` axis: one expert a
    rank, the batch split over the same axis (see the module
    docstring)."""

    def __init__(self, expert_fn: Callable, n_experts: int, mesh,
                 capacity_factor: float = 1.0, axis: str = EXPERT_AXIS):
        if mesh.shape[axis] != n_experts:
            raise ValueError(f"mesh axis {axis!r} has {mesh.shape[axis]} "
                             f"devices, need n_experts={n_experts}")
        self.expert_ref = fn_ref(expert_fn, "expert_fn")
        self.expert_fn = expert_fn
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.mesh = mesh
        self.axis = axis

    def capacity(self, n_local: int) -> int:
        """C = max(1, ceil(capacity_factor * n_local / n_experts))."""
        return max(1, int(np.ceil(self.capacity_factor * n_local
                                  / self.n_experts)))

    def shard_params(self, stacked_expert_params) -> Dict[str, Tensor]:
        """The stacked [E, ...] experts on the driver's device; each call
        sends every rank its expert."""
        return {k: _tensor(a, self.mesh.device)
                for k, a in stacked_expert_params.items()}

    def _call(self, stacked, gate_w, x, grad: bool, dy_of=None):
        stacked = self.shard_params(stacked)
        gate_w = _tensor(gate_w, self.mesh.device)
        x = _tensor(x, self.mesh.device)
        if x.shape[0] % self.n_experts:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"n_experts={self.n_experts}")
        n_local = x.shape[0] // self.n_experts
        meta = {"axis": self.axis, "grad": grad, "expert": self.expert_ref,
                "dtype": str(x.dtype).split(".")[-1], "n_local": n_local,
                "d": int(x.shape[1]), "capacity": self.capacity(n_local),
                "gate_shape": tuple(gate_w.shape),
                "param_shapes": {k: tuple(v.shape[1:])
                                 for k, v in stacked.items()}}
        self.mesh.start()
        return self.mesh.run_service(
            _FACTORY, OP_MOE, meta,
            lambda: _rank_part(self.mesh, meta, stacked, gate_w, x, dy_of))

    def apply(self, stacked_expert_params, gate_w, x) -> Tensor:
        """x: [B, D] global batch (split over the expert axis)."""
        with torch.no_grad():
            ys, _ = self._call(stacked_expert_params, gate_w, x, False)
        return ys

    def grad_fn(self, loss_fn: Callable):
        """``f(stacked, gate_w, x, target) -> (loss, (expert grads, router
        grad))`` through dispatch and the all-to-alls; ``loss_fn`` runs
        on the driver only."""

        def value_and_grad(stacked_expert_params, gate_w, x, target):
            t = _tensor(target, self.mesh.device)
            loss = []

            def dy_of(ys):
                with torch.enable_grad():
                    y = ys.detach().requires_grad_(True)
                    value = loss_fn(y, t)
                    (gy,) = torch.autograd.grad(value, y)
                loss.append(value.detach())
                return gy.contiguous()

            _, grads = self._call(stacked_expert_params, gate_w, x, True,
                                  dy_of)
            return loss[0], grads

        return value_and_grad
