"""Cross-replica weight-update (optimizer-state) sharding, ZeRO stage 1 —
port of deeplearning4j_tpu/parallel/zero.py (JAX :37-76).

After "Automatic Cross-Replica Sharding of Weight Update in Data-Parallel
Training" (arXiv:2004.13336): every data-parallel replica holds the whole
optimizer state and makes the same update; sharding the state over the
data axis has each replica keep and update only its slice, at the cost
of gathering the updated params.

JAX annotates the state and GSPMD partitions the update. The port does
the same work by hand under `IciDataParallelTrainingMaster`:
`shard_updater_state` chooses JAX's rule for every state tensor — its
largest dim divisible by the axis size, else replicated — and keeps on
the net only this rank's (the driver's, data coordinate 0) slice of each
sharded tensor; each follower takes its own at the master's first sync.
Every step the gradient is all-reduced whole (gradient normalization
runs on it whole), then each data rank updates its slice of each
sharded param with its slice of the state and all-gathers the updated
slices (`nn/updater/apply.update_layer_`): elementwise updaters give
the same bits as the unsharded step. ``net.updater_state`` (and so
``updater_state_flat``, the model zip and a checkpoint) reads the whole
state, gathered over the data axis when read after a step; a setter
hands the ranks their slices of the new whole. A ZeRO-1 net trains under
the ICI master only (its own step raises), and not under tensor
parallelism.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .mesh import DATA_AXIS, default_mesh


def refuse_own_step() -> None:
    raise ValueError(
        "a net whose updater state ZeRO-1 sharded (shard_updater_state) "
        "trains under IciDataParallelTrainingMaster on its mesh, not by "
        "its own fit")


def _layers(tree):
    """(key, value) of a facade's per-layer list or dict."""
    return list(tree.items()) if isinstance(tree, dict) else list(
        enumerate(tree))


def _rule(shape, n: int) -> Optional[int]:
    """JAX's rule: the largest dim of ``shape`` divisible by ``n`` (and at
    least ``n``), else None."""
    if n <= 1 or not shape:
        return None
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] >= n and shape[d] % n == 0:
            return d
    return None


def _narrow(t: torch.Tensor, d: Optional[int], n: int, r: int):
    if d is None:
        return t
    c = t.shape[d] // n
    return t.narrow(d, r * c, c)


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return [_host(v) for v in tree]


class ZeroPlan:
    """``net._zero``: the data axis, each param's dim (``dims[layer]
    [param]``, None: replicated), the whole state as last read
    (``full``, host tensors; current while ``valid``) and the whole state
    the follower ranks have not taken yet (``pending``)."""

    def __init__(self, axis: str, n: int, dims, full):
        self.axis = axis
        self.n = int(n)
        self.dims = dims
        self.full = full
        self.valid = True
        self.pending = full
        self.ranks = None

    def spec(self) -> Dict[str, Any]:
        return {"axis": self.axis, "n": self.n, "dims": self.dims}

    def take_pending(self):
        """The whole state for the followers' sync (None: they hold their
        slices already)."""
        out, self.pending = self.pending, None
        return out

    def bind(self, ranks) -> None:
        """The master whose followers hold the other slices."""
        self.ranks = ranks

    def stepped(self) -> None:
        self.valid = False

    def whole(self, net):
        """The whole updater state (host tensors), gathered over the data
        axis after a step."""
        if not self.valid:
            from .trainer import OP_ZERO_GATHER, _data_comm
            ranks = self.ranks
            comm = ranks.mesh
            got = ranks.run(OP_ZERO_GATHER, {},
                            lambda: self.gather_whole(net, _data_comm(comm)))
            self.full = _host(got)
            self.valid = True
        return self.full

    def gather_whole(self, net, comm):
        """Every sharded state tensor all-gathered along its dim over
        ``comm`` (one all-gather a tensor); the replicated as they are."""
        out = [] if isinstance(net._updater_state, list) else {}
        for key, lu in _layers(net._updater_state):
            layer = {p: {s: (t if self.dims[key][p] is None else
                             comm.all_gather(t, self.dims[key][p]))
                         for s, t in st.items()}
                     for p, st in lu.items()}
            if isinstance(out, list):
                out.append(layer)
            else:
                out[key] = layer
        return out

    def reslice(self, net, fresh: bool = False) -> None:
        """The whole state was set on the driver — written into ``full``
        in place, or (``fresh``) a new whole state in the net by
        ``init()``: the driver keeps its slices, the followers take
        theirs at the master's next sync."""
        if fresh:
            self.full = _host(net._updater_state)
        _place(net, self.spec(), self.full, 0)
        self.pending = self.full
        self.valid = True


def follow_plan(net, spec, whole, r: int) -> None:
    """A follower replica at the master's sync, data rank ``r``: take the
    plan, and its slices of ``whole`` when the driver sends one."""
    if net._zero is None:
        net._zero = ZeroPlan(spec["axis"], spec["n"], spec["dims"], None)
        net._zero.pending = None
    if whole is not None:
        _place(net, spec, whole, r)
    net._zero.valid = False


def _place(net, spec, whole, r: int) -> None:
    """Replace ``net``'s updater state by rank ``r``'s slices of
    ``whole`` (fresh tensors on the net's device)."""
    n = spec["n"]
    new = [] if isinstance(net._updater_state, list) else {}
    for key, lu in _layers(whole):
        layer = {p: {s: _narrow(t, spec["dims"][key][p], n, r).clone().to(
            net.device) for s, t in st.items()} for p, st in lu.items()}
        if isinstance(new, list):
            new.append(layer)
        else:
            new[key] = layer
    net._updater_state = new
    net._graphs.drop()


def shard_updater_state(net, mesh=None, axis: str = DATA_AXIS):
    """Shard ``net``'s updater state over ``mesh``'s ``axis`` (see the
    module docstring; default mesh: every card). Call after ``init()``
    (or a restore), before training under `IciDataParallelTrainingMaster`
    on the same mesh. Returns (sharded leaves, total leaves), JAX's
    counts."""
    mesh = mesh or default_mesh()
    n = int(mesh.shape[axis])
    net._check_init()
    if net._tp is not None:
        raise NotImplementedError(
            "ZeRO-1 over a tensor-parallel net is not ported")
    stats = [0, 0]
    dims = {}
    for key, lu in _layers(net.updater_state):
        dims[key] = {}
        for p, st in lu.items():
            d = None
            for s, t in st.items():
                stats[1] += 1
                dt = _rule(tuple(t.shape), n)
                if dt is not None:
                    stats[0] += 1
                    d = dt
            dims[key][p] = d
    if net._zero is not None:
        net._zero.dims = dims
        return stats[0], stats[1]
    plan = ZeroPlan(axis, n, dims, _host(net.updater_state))
    _place(net, plan.spec(), plan.full, 0)
    net._zero = plan
    return stats[0], stats[1]


def updater_state_bytes_per_device(net) -> int:
    """The optimizer-state bytes this rank holds on its device: the
    slices of a ZeRO-1 net's sharded tensors, every other tensor whole."""
    total = 0
    for _, lu in _layers(net._updater_state):
        for st in lu.values():
            for t in st.values():
                total += t.numel() * t.element_size()
    return int(total)
