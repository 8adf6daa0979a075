"""Megatron tensor parallelism for ComputationGraph networks — port of
deeplearning4j_tpu/parallel/tensor_parallel.py: the spec plan
(`_tp_specs_for_graph`, JAX :31-58) and `shard_transformer_tp` (JAX
:61-103).

A spec is a tuple with one entry a parameter dim: the mesh axis name that
dim is split over, or None; ``()`` is replicated. Each equals, entry for
entry, the JAX package's `PartitionSpec` (``tuple(P(None, "tp")) ==
(None, "tp")``). The pairing:

  - SelfAttentionLayer: Wq/Wk/Wv split by column (heads), Wo by row,
    ``b`` replicated — one all-reduce per attention block;
  - a DenseLayer fed by a column-split DenseLayer alone: split by row
    (the FFN down-projection), ``b`` replicated;
  - any other DenseLayer with an activation: split by column with its
    ``b`` (the FFN up-projection);
  - everything else replicated.

The decode engine reads this plan through `inference/sharding.py`, with
the output vertices forced replicated; training reuses that module's
modes (`shard_modes`: heads, col, col_gather, row) and its rank graph
(`shard_graph`).

`shard_transformer_tp(net, mesh, axis)`. JAX annotates the arrays and
GSPMD partitions the jitted step. The port splits them: every rank of the
mesh (rank 0 is the driver, the others followers running a tp training
service, `_TpService`) holds a graph of the rank's local widths over its
slices of the params and of the updater state (momentum follows the
weights) on its ``axis`` coordinate, and runs the same step. Megatron's
autograd collectives (`parallel/tp_autograd.py`) carry the step: a layer
split by head or column takes its input through `copy_to_tp`, a layer
split by row sums its partial product with `reduce_from_tp` before the
bias, a ``col_gather`` vertex gathers its output with `gather_from_tp`.
The step's global sums hold over the split params (`nn/graph.py`): the
l1/l2 term of the split weights and the L2 norms of gradient
normalization are all-reduced over the axis before they are used, and
every replicated param gets the same gradient bits on every rank (the
all-reduce hands each rank the same sum).

Afterwards the net's own ``fit`` / ``fit_batch`` / ``fit_scan`` /
``fit_batch_accumulated`` run the step on every rank, one command a
call, eagerly (a gloo collective cannot sit in a captured CUDA graph; a
net that captures its step raises: the captured tp step under NCCL is
ROADMAP A7.2.6). ``net.params`` and ``net.updater_state`` read as the
whole arrays, gathered over the axis when read after a step (one
command, one all-gather per dtype), so ``save``, the model zip,
checkpoints and ``params_flat()`` see JAX's layout; the setters
(``set_params*``, ``set_updater_state_flat``, ``set_variables``) hand
the new whole state to every rank, which takes its slices. Inference
(``output``, ``score``) runs on the driver over the gathered params.

A dim the axis does not divide is replicated with JAX's warning (JAX
:76-90). The port never splits a head: an attention layer whose heads
the axis does not divide is replicated whole, and a GQA layer whose KV
heads it does not divide keeps Wk/Wv whole on every rank (the
"heads_kv" mode), each rank repeating them to its query heads.
"""
from __future__ import annotations

import pickle
import warnings
from typing import Dict, List, Optional, Tuple

import torch

from .mesh import SERVICE_OPS, backend_flags, set_backend_flags

MODEL_AXIS_DEFAULT = "model"

Spec = Tuple

# the tp service's ops (after trainer.py's, which it also answers)
OP_TP_CALL, OP_TP_GATHER, OP_TP_LOAD, OP_TP_REPLICAS = range(
    SERVICE_OPS + 8, SERVICE_OPS + 12)

# the facade methods a tp step may be asked for
_CALLS = ("fit_batch", "fit_scan", "fit_batch_accumulated")


def _tp_specs_for_graph(conf, axis: str) -> Dict[str, Dict[str, Spec]]:
    """Per-vertex, per-param specs of the Megatron scheme."""
    from ..nn.conf.graph import LayerVertex
    from ..nn.conf.layers import DenseLayer, SelfAttentionLayer

    specs: Dict[str, Dict[str, Spec]] = {}
    col_vertices = set()
    for name in conf.topological_order():
        vertex = conf.vertices[name]
        if not isinstance(vertex, LayerVertex):
            continue
        layer = vertex.layer
        srcs = conf.vertex_inputs[name]
        if isinstance(layer, SelfAttentionLayer):
            specs[name] = {"Wq": (None, axis), "Wk": (None, axis),
                           "Wv": (None, axis), "Wo": (axis, None),
                           "b": ()}
        elif isinstance(layer, DenseLayer):
            if len(srcs) == 1 and srcs[0] in col_vertices:
                specs[name] = {"W": (axis, None), "b": ()}
            elif (layer.activation or "identity") != "identity":
                specs[name] = {"W": (None, axis), "b": (axis,)}
                col_vertices.add(name)
            else:
                specs[name] = {}
        else:
            specs[name] = {}
    return specs


def _split_dim(spec: Spec) -> Optional[int]:
    for d, ax in enumerate(spec):
        if ax is not None:
            return d
    return None


def train_plan(net, tp: int, axis: str = MODEL_AXIS_DEFAULT
               ) -> Tuple[Dict[str, Dict[str, Spec]], Dict[str, str]]:
    """(effective specs, modes) of training ``net`` over a ``tp``-rank
    axis: the plan with every dim ``tp`` does not divide replicated
    (JAX's warning), no head split (see the module docstring), and any
    split vertex without a mode of `inference.sharding.shard_modes`
    replicated."""
    from ..inference.sharding import shard_modes
    from ..nn.conf.graph import LayerVertex
    from ..nn.conf.layers import SelfAttentionLayer
    conf = net.conf
    specs = _tp_specs_for_graph(conf, axis)
    eff: Dict[str, Dict[str, Spec]] = {}
    for name, lp in net.params.items():
        vs = {}
        for pname, arr in lp.items():
            spec = tuple(specs.get(name, {}).get(pname, ()))
            for d, ax in enumerate(spec):
                if ax is not None and arr.shape[d] % tp:
                    # a dim that the mesh axis does not evenly divide (a
                    # GQA layer's shrunken Wk/Wv) falls back to
                    # replication — loudly (JAX :76-90)
                    warnings.warn(
                        f"shard_transformer_tp: {name}/{pname} dim {d} (size "
                        f"{arr.shape[d]}) is not divisible by mesh axis "
                        f"'{ax}' ({tp}); replicating this param",
                        stacklevel=3)
                    spec = ()
                    break
            vs[pname] = spec
        eff[name] = vs
    if tp > 1:
        for name, vs in eff.items():
            v = conf.vertices[name]
            if not (isinstance(v, LayerVertex)
                    and isinstance(v.layer, SelfAttentionLayer)):
                continue
            H = v.layer.n_heads
            Hkv = getattr(v.layer, "n_kv_heads", None) or H
            if H % tp and any(vs.values()):
                warnings.warn(
                    f"shard_transformer_tp: {name} has {H} heads, not "
                    f"divisible by mesh axis ({tp}); a rank holds whole "
                    "heads, so this layer is replicated", stacklevel=3)
                eff[name] = {p: () for p in vs}
            elif Hkv % tp and (vs.get("Wk") or vs.get("Wv")):
                warnings.warn(
                    f"shard_transformer_tp: {name} has {Hkv} KV heads, not "
                    f"divisible by mesh axis ({tp}); Wk/Wv stay whole on "
                    "every rank", stacklevel=3)
                vs["Wk"] = vs["Wv"] = ()
    modes = shard_modes(conf, eff)
    for name, vs in eff.items():
        if name not in modes and any(vs.values()):
            warnings.warn(f"shard_transformer_tp: {name} has no "
                          "tensor-parallel form; replicating this layer",
                          stacklevel=3)
            eff[name] = {p: () for p in vs}
    return eff, modes


# -- a rank's graph --------------------------------------------------------
def _slice(arr: torch.Tensor, spec: Spec, tp: int, rank: int) -> torch.Tensor:
    d = _split_dim(spec)
    if d is None:
        return arr
    n = arr.shape[d] // tp
    return arr.narrow(d, rank * n, n)


def _leaf_items(eff, params, ustate):
    """(spec, tensor) of every param and updater-state leaf, in the flat
    order (layers, params, state names sorted)."""
    out = []
    for name in sorted(params):
        for pname in sorted(params[name]):
            spec = eff[name][pname]
            out.append((spec, params[name][pname]))
            st = ustate.get(name, {}).get(pname, {})
            for sname in sorted(st):
                out.append((spec, st[sname]))
    return out


def _load_whole(g, eff, comm, state) -> None:
    """Copy the rank's slices of a whole ``state`` (params, updater
    state, variables; CPU tensors) into the rank graph ``g``."""
    from ..nn.step_graph import copy_into
    tp, r = comm.size, comm.rank
    with torch.no_grad():
        for name, lp in g.params.items():
            for pname, t in lp.items():
                spec = eff[name][pname]
                t.copy_(_slice(state["params"][name][pname], spec, tp, r))
                for sname, st in g.updater_state[name][pname].items():
                    st.copy_(_slice(state["updater_state"][name][pname][sname],
                                    spec, tp, r))
        copy_into(g.variables, state["variables"])


def _rank_graph(conf, eff, modes, comm, device, state, step: int,
                variables=None):
    """This rank's graph (`inference.sharding.shard_graph`) over its slices
    of ``state``, with its updater state and the split params' names
    (the step's global sums, `nn/graph.py`)."""
    from ..inference.sharding import shard_graph
    tp, r = comm.size, comm.rank
    params = {n: {k: _slice(v, eff[n][k], tp, r).clone()
                  for k, v in lp.items()}
              for n, lp in state["params"].items()}
    if variables is None:
        variables = state["variables"]
    g = shard_graph(conf, modes, tp, params, variables, device, comm)
    g.updater_state = {
        n: {k: {s: _slice(t, eff[n][k], tp, r).clone().to(device)
                for s, t in st.items()}
            for k, st in lu.items()}
        for n, lu in state["updater_state"].items()}
    g._tp_split = {n: {k for k, spec in vs.items() if _split_dim(spec)
                       is not None}
                   for n, vs in eff.items()}
    g._tp_comm = comm
    g.step = int(step)
    return g


def _gather_whole(g, eff, comm):
    """(params, updater state) of the whole net from the ranks' slices:
    one all-gather per dtype of every split leaf, over ``comm``."""
    leaves = _leaf_items(eff, g.params, g.updater_state)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, (spec, t) in enumerate(leaves):
        if _split_dim(spec) is not None:
            groups.setdefault(t.dtype, []).append(i)
    whole: List[torch.Tensor] = [t for _, t in leaves]
    for _, idx in groups.items():
        flat = torch.cat([leaves[i][1].reshape(-1) for i in idx])
        got = comm.all_gather(flat.unsqueeze(0), 0)  # [tp, n]
        off = 0
        for i in idx:
            spec, t = leaves[i]
            n = t.numel()
            parts = [got[r, off:off + n].view(t.shape)
                     for r in range(comm.size)]
            whole[i] = torch.cat(parts, dim=_split_dim(spec))
            off += n
    it = iter(whole)
    params, ustate = {}, {}
    for name in sorted(g.params):
        params[name], ustate[name] = {}, {}
        for pname in sorted(g.params[name]):
            params[name][pname] = next(it)
            st = g.updater_state.get(name, {}).get(pname, {})
            ustate[name][pname] = {s: next(it) for s in sorted(st)}
    return params, ustate


def _replicas(g, eff, comm) -> torch.Tensor:
    """[tp, n]: every rank's replicated params, flat (the axis's
    all-gather), to hold their bits equal across the ranks."""
    flat = torch.cat([g.params[n][k].detach().reshape(-1).float()
                      for n in sorted(g.params) for k in sorted(g.params[n])
                      if _split_dim(eff[n][k]) is None])
    return comm.all_gather(flat.unsqueeze(0), 0)


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


class _TpService:
    """A follower's tp training service: its rank graph, run by the
    driver's commands (`OP_TP_CALL`, `OP_TP_GATHER`, `OP_TP_LOAD`, and the
    ICI master's `OP_SYNC` of the step and `OP_ICI_STEP` for dp x tp)."""

    def __init__(self, comm, p):
        set_backend_flags(p["flags"])
        self.comm = comm
        self.eff = p["eff"]
        self.mcomm = comm.axis_comm(p["axis"])
        self.g = _rank_graph(p["conf"], p["eff"], p["modes"], self.mcomm,
                             comm.device, p["state"], p["step"])

    def handle(self, cmd) -> None:
        from .trainer import OP_ICI_STEP, OP_SYNC, _data_comm, _ici_step
        data = pickle.loads(self.comm.broadcast_bytes(None, cmd.args[0]))
        op = cmd.op
        if op == OP_TP_CALL:
            self.g.step = int(data["step"])
            getattr(self.g, data["method"])(*data["args"])
        elif op == OP_TP_GATHER:
            _gather_whole(self.g, self.eff, self.mcomm)
        elif op == OP_TP_REPLICAS:
            _replicas(self.g, self.eff, self.mcomm)
        elif op == OP_TP_LOAD:
            _load_whole(self.g, self.eff, self.mcomm, data["state"])
            self.g.step = int(data["step"])
        elif op == OP_ICI_STEP:
            _ici_step(self.g, _data_comm(self.comm), data)
        elif op == OP_SYNC:
            self.g.step = int(data["step"])
        else:
            raise ValueError(f"unknown tp command {op}")

    def close(self) -> None:
        self.g = None


def _tp_service(comm, p) -> _TpService:
    return _TpService(comm, p)


class TpTraining:
    """The driver's side of a tensor-parallel net (``net._tp``): its rank
    graph, the followers' service, and the whole arrays it gathers when
    they are read after a step."""

    def __init__(self, net, mesh, axis, eff, modes):
        self.mesh = mesh
        self.axis = axis
        self.eff = eff
        self.modes = modes
        self.comm = mesh.axis_comm(axis)
        self.tp = self.comm.size
        state = {"params": net._params, "updater_state": net._updater_state,
                 "variables": net.variables}
        self.graph = _rank_graph(net.conf, eff, modes, self.comm, net.device,
                                 state, net.step, variables=net.variables)
        self.sid = mesh.attach(
            "deeplearning4j_tpu_torch.parallel.tensor_parallel:_tp_service",
            {"conf": net.conf, "axis": axis, "eff": eff, "modes": modes,
             "state": _host(state), "step": int(net.step),
             "flags": backend_flags()})
        self.version = 0      # steps taken since the last gather
        self.gathered = 0

    def run(self, op: int, data, fn):
        """One command to every follower's service with ``data`` (one
        data broadcast), then ``fn()`` here."""
        mesh = self.mesh
        if mesh.size == 1:
            return fn()
        blob = pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)
        with mesh.exclusive():
            mesh.command(op, self.sid, (len(blob),))
            mesh.broadcast_bytes(blob, len(blob))
            return fn()

    def call(self, net, method: str, *args):
        """``net.<method>(*args)`` run by every rank on its graph from the
        net's step; the net takes the rank graph's step and score, and its
        listeners are told of each step."""
        from ..nn.precision import host_floats
        if method not in _CALLS:
            raise ValueError(f"no tensor-parallel {method}")

        def host(a):
            if a is None:
                return None
            if isinstance(a, (list, tuple)):
                return [host(x) for x in a]
            if isinstance(a, torch.Tensor):
                return host_floats(a.detach().cpu().numpy()) \
                    if a.is_floating_point() else a.detach().cpu().numpy()
            return a
        step0 = self.graph.step = int(net.step)
        out = self.run(OP_TP_CALL, {"method": method, "args": host(args),
                                    "step": step0},
                       lambda: getattr(self.graph, method)(*args))
        self.version += 1
        net.step = self.graph.step
        net._score_raw = self.graph._score_raw
        for s in range(step0 + 1, net.step + 1):
            for listener in net.listeners:
                listener.iteration_done(net, s)
        return out

    def refresh(self, net) -> None:
        """Make the net's whole params and updater state current: one
        gather after any step since the last."""
        if self.gathered == self.version:
            return
        from ..nn.step_graph import copy_into
        params, ustate = self.run(
            OP_TP_GATHER, {}, lambda: _gather_whole(self.graph, self.eff,
                                                    self.comm))
        copy_into(net._params, params)
        copy_into(net._updater_state, ustate)
        self.gathered = self.version

    def push(self, net) -> None:
        """Hand the net's whole state (just set on the driver) to every
        rank, which takes its slices."""
        state = {"params": net._params, "updater_state": net._updater_state,
                 "variables": net.variables}
        self.run(OP_TP_LOAD, {"state": _host(state), "step": int(net.step)},
                 lambda: _load_whole(self.graph, self.eff, self.comm, state))
        self.graph.step = int(net.step)

    def replicas(self) -> torch.Tensor:
        """[tp, n]: each rank of the driver's axis group's replicated
        params, flat: every row holds the same bits when the ranks kept
        lockstep."""
        return self.run(OP_TP_REPLICAS, {}, lambda: _replicas(
            self.graph, self.eff, self.comm))

    def stepped(self) -> None:
        """A step ran on the ranks outside `call` (the ICI master's)."""
        self.version += 1


def shard_transformer_tp(net, mesh, axis: str = MODEL_AXIS_DEFAULT) -> None:
    """Split ``net``'s params and updater state over ``mesh``'s ``axis``
    (see the module docstring). Afterwards train with the net's own
    ``fit`` methods, or — for dp x tp — hand the net to
    `IciDataParallelTrainingMaster` on the same mesh, which keeps the
    split and shards the batch over the ``data`` axis. ``mesh`` is a
    `parallel.mesh.ProcessMesh` whose rank 0 runs on the net's device; it
    is started here."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis '{axis}' "
                         f"(axes: {mesh.axis_names})")
    if not hasattr(net.conf, "vertices"):
        raise ValueError("shard_transformer_tp takes a ComputationGraph")
    net._check_init()
    if net._graphs.capturing:
        raise ValueError(
            "tensor-parallel training with train_graphs='on' on the card: a "
            "gloo collective cannot sit in a captured CUDA graph, so the tp "
            "step runs eagerly (build the net with train_graphs='off'; a "
            "captured tp step under NCCL is ROADMAP A7.2.6)")
    if mesh.device != net.device:
        raise ValueError(f"the mesh's rank 0 runs on {mesh.device}, the net "
                         f"lives on {net.device}")
    if net._tp is not None:
        raise ValueError("the net is already tensor-parallel")
    if net._zero is not None:
        raise NotImplementedError(
            "tensor parallelism over a ZeRO-1 net (shard_updater_state "
            "first) is not ported; shard the updater state of a net that "
            "is not tensor-parallel")
    eff, modes = train_plan(net, int(mesh.shape[axis]), axis)
    mesh.start()
    net._tp = TpTraining(net, mesh, axis, eff, modes)


def param_spec(net, layer: str, param: str) -> Spec:
    """The spec ``net``'s ``layer``/``param`` is split by (``()``:
    replicated, also for a net that is not tensor-parallel): the port's
    counterpart of reading a JAX array's sharding."""
    return () if net._tp is None else tuple(net._tp.eff[layer][param])
