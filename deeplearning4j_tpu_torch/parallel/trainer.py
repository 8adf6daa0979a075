"""Data-parallel training masters — port of
deeplearning4j_tpu/parallel/trainer.py (:41-496).

Capability parity with the reference's distributed stack, as in the JAX
package: the `TrainingMaster` SPI, `ParameterAveragingTrainingMaster`
(synchronous parameter averaging, ``averaging_frequency`` local updates a
round), `IciDataParallelTrainingMaster` (a gradient all-reduce every
step) and `ParallelWrapper`.

The ranks are processes (`parallel/mesh.py`): the caller's process is rank
0 and trains the caller's net; each follower holds a replica of it (built
from the net's configuration at the first `execute_training`, and handed
rank 0's parameters, variables, updater state and step at the start of
every call). The driver reads the iterator and broadcasts each (padded)
batch; every rank takes its contiguous shard, as the JAX mesh's data axis
shards the batch. After `execute_training` returns the caller's net holds
the final parameters and updater state.

`IciDataParallelTrainingMaster`, per step (JAX :144-240):
  - a ragged batch is padded to a multiple of the rank count with cyclic
    duplicates carrying loss weight 0 (`_pad_ragged`);
  - each rank's loss is its weighted sum over the GLOBAL weight (its
    masked mean times its share of the weight), and the l1/l2 term enters
    on rank 0 only, so the summed gradient is the global batch's;
  - BatchNorm's batch statistics are global (`ops.helpers.bn_sync`): the
    forward's mean and variance, and between the BN+act+pool backward's
    sums and dx launches its per-channel sums, are all-reduced;
  - one flat all-reduce of every gradient (and the loss) a step, then
    every rank applies the same update.
The step runs eagerly between the gradient and the update by the master's
own choice: a gloo all-reduce cannot sit inside the CUDA graph the net's
own captured step records (nn/step_graph.py). The caller's net keeps its
``train_graphs`` setting for its own fits.

`ParameterAveragingTrainingMaster` (JAX :243-460): each rank runs
``averaging_frequency`` local steps of ``batch_size_per_worker`` through
the net's own step (captured on the card, as a local fit is), skipping a
minibatch of zero-weight fill entirely; then one flat all-reduce averages
parameters, variables and updater state, and sums the example-weighted
loss. BatchNorm statistics stay local, as under the JAX shard_map.

Meshes of more than one axis (JAX :175-232): the ICI master splits the
batch over the ``data`` axis only, padded to a multiple of the whole
mesh's size as JAX pads it, and all-reduces the flat gradient over the
``data`` group (`_data_comm`); the ranks of the other axes repeat their
data row's work. A net made tensor-parallel on the same mesh
(`tensor_parallel.shard_transformer_tp`) keeps its split — JAX's
``keep_or_repl`` — and each rank steps its tp graph (the tp service takes
the master's commands); anything else is replicated. A net whose updater
state ZeRO-1 sharded (`zero.shard_updater_state`) updates only each data
rank's slice and all-gathers the updated params (`nn/updater/apply.py`).

Fault tolerance (JAX :152-245, :264-466; `parallel/statetracker.py`):
``state_tracker`` checkpoints from the driver, whose net holds the job's
state — the ICI master after every step (cursor ``master_batches``), the
parameter-averaging master after every round that leaves no rows carried
over (cursor ``round`` and ``master_batches``) — and waits for the last
checkpoint before `execute_training` returns. `resume(net)` restores the
newest checkpoint into the driver's net, re-syncs the followers (one
``OP_SYNC``) and returns the leading batches of the same data sequence
that the next `execute_training` skips. A follower that dies makes the
driver's next collective raise; the job restarts on the ranks left
(`statetracker.fit_with_recovery`, the roster's disabled worker).
"""
from __future__ import annotations

import pickle
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .mesh import (DATA_AXIS, SERVICE_OPS, STATS, MeshError, ProcessMesh,
                   backend_flags, default_mesh, set_backend_flags)
from .stats import SparkTrainingStats, phase_timer

OP_SYNC, OP_ICI_STEP, OP_PA_ROUND, OP_EVAL, OP_SCORE, OP_ZERO_GATHER = \
    range(SERVICE_OPS, SERVICE_OPS + 6)


def _data_comm(comm):
    """The communicator the ICI step shards the batch and all-reduces the
    gradient over: a 1-D mesh itself (whatever its axis), else the rank's
    ``data`` group."""
    if len(comm.axis_names) <= 1:
        return comm
    if DATA_AXIS not in comm.axis_names:
        raise ValueError(f"a mesh of axes {comm.axis_names} has no "
                         f"'{DATA_AXIS}' axis to split the batch over")
    return comm.axis_comm(DATA_AXIS)


class TrainingMaster:
    """SPI (reference spark/api/TrainingMaster.java)."""

    def execute_training(self, net, iterator) -> None:
        raise NotImplementedError

    def get_training_stats(self) -> Optional[SparkTrainingStats]:
        return None

    def close(self) -> None:
        """Stop the followers this master started."""


def _is_graph(net) -> bool:
    return hasattr(net.conf, "vertices")


def _as_lists(ds):
    """(inputs, labels, fmasks, lmasks) lists of a DataSet or
    MultiDataSet — one entry per network input/output."""
    if hasattr(ds, "features_masks"):  # MultiDataSet
        return (list(ds.features), list(ds.labels),
                list(ds.features_masks) if ds.features_masks else None,
                list(ds.labels_masks) if ds.labels_masks else None)
    fm = getattr(ds, "features_mask", None)
    lm = getattr(ds, "labels_mask", None)
    return ([ds.features], [ds.labels],
            [fm] if fm is not None else None,
            [lm] if lm is not None else None)


def _np(a):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _ones_lmask(y, need: int, orig: int) -> np.ndarray:
    """Per-example loss weights: 1 for real rows, 0 for fill rows past
    ``orig``; [need] for 2-D labels, [need, T] for time series."""
    m = np.ones((need,) if y.ndim == 2 else (need, y.shape[1]), np.float32)
    m[min(orig, need):] = 0.0
    return m


def _pad_ragged(inputs, labels, fmasks, lmasks, n_dev):
    """Pad the batch axis to a multiple of ``n_dev`` with cyclic
    duplicates carrying ZERO loss weight (JAX :117)."""
    orig = inputs[0].shape[0]
    if orig % n_dev == 0:
        return inputs, labels, fmasks, lmasks
    need = -(-orig // n_dev) * n_dev
    idx = np.arange(need) % orig
    inputs = [a[idx] for a in inputs]
    labels = [a[idx] for a in labels]
    if fmasks is not None:
        fmasks = [np.asarray(m)[idx] if m is not None else None
                  for m in fmasks]
    if lmasks is None:
        lmasks = [None] * len(labels)
    out_lm = []
    for y, m in zip(labels, lmasks):
        if m is None:
            m = _ones_lmask(y, need, orig)
        else:
            m = np.asarray(m)[idx].astype(np.float32, copy=True)
            m[orig:] = 0.0
        out_lm.append(m)
    return inputs, labels, fmasks, out_lm


# -- shared by every rank -------------------------------------------------
def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in _leaves(tree[k])]
    return [t for v in tree for t in _leaves(v)]


def _all_reduce_flat(comm, tensors: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """Sum ``tensors`` over the ranks: one flat all-reduce per dtype (one,
    for a net of one dtype). Returns the summed tensors in order."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    t0 = time.perf_counter()
    nbytes = 0
    for _, idx in groups.items():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        comm.all_reduce(flat)
        nbytes += flat.numel() * flat.element_size()
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    if comm.size > 1:
        STATS["all_reduce_s"] = time.perf_counter() - t0
        STATS["all_reduce_bytes"] = float(nbytes)
    return out  # type: ignore[return-value]


def _state_tree(net):
    return {"params": net.params, "variables": net.variables,
            "updater_state": net.updater_state}


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return [_cpu(v) for v in tree]


def _state_payload(net) -> Dict[str, Any]:
    """Rank 0's state for the followers' replicas; a ZeRO-1 net sends its
    plan, and its whole updater state only when the ranks do not hold
    their slices of it yet (`zero.ZeroPlan.pending`)."""
    zero = net._zero
    if zero is None:
        return {"state": _cpu(_state_tree(net)), "step": int(net.step),
                "flags": backend_flags()}
    return {"state": {"params": _cpu(net.params),
                      "variables": _cpu(net.variables)},
            "step": int(net.step), "flags": backend_flags(),
            "zero": zero.spec(), "whole_updater": zero.take_pending()}


def _load_state(net, payload, data_rank: int = 0) -> None:
    from ..nn.step_graph import copy_into
    if "zero" in payload:
        from .zero import follow_plan
        copy_into(net.params, payload["state"]["params"])
        copy_into(net.variables, payload["state"]["variables"])
        follow_plan(net, payload["zero"], payload["whole_updater"],
                    data_rank)
    else:
        copy_into(_state_tree(net), payload["state"])
    net.step = int(payload["step"])
    set_backend_flags(payload["flags"])


def _shard(arrs, r: int, n: int):
    if arrs is None:
        return None
    out = []
    for a in arrs:
        if a is None:
            out.append(None)
            continue
        b = a.shape[0] // n
        out.append(a[r * b:(r + 1) * b])
    return out


def _weights(labels, lmasks, r: int, n: int) -> List[float]:
    """Each output's share of the global loss weight held by rank ``r``:
    max(W_r, 1) / max(W, 1), the masked means' denominators
    (ops/losses._reduce), so that the ranks' scaled losses sum to the
    global batch's."""
    out = []
    for i, y in enumerate(labels):
        m = None if lmasks is None else lmasks[i]
        if m is None:
            out.append(1.0 / n)
            continue
        m = np.asarray(m, np.float32)
        b = m.shape[0] // n
        w_r = float(m[r * b:(r + 1) * b].sum())
        out.append(max(w_r, 1.0) / max(float(m.sum()), 1.0))
    return out


def _tensors(net, arrs):
    if arrs is None:
        return None
    return [net._as_tensor(a) if a is not None else None for a in arrs]


def _grads(net, ins, labs, fms, lms, scales, with_reg):
    """(loss, flat gradient list, grads tree, new variables) of one
    train-mode step on device tensors."""
    if _is_graph(net):
        fmd = (dict(zip(net.conf.network_inputs, fms))
               if fms is not None else None)
        loss, grads, new_vars, _ = net._grads_on(
            ins, labs, fmd, lms, None, net.variables, loss_scales=scales,
            with_reg=with_reg)
    else:
        loss, grads, new_vars, _ = net._grads_on(
            ins[0], labs[0], fms[0] if fms else None,
            lms[0] if lms else None, None, net.variables,
            loss_scales=scales, with_reg=with_reg)
    return loss, grads, new_vars


def _ici_step(net, comm, batch) -> torch.Tensor:
    """One IciDataParallel step on this rank's shard of the padded global
    ``batch`` = (inputs, labels, fmasks, lmasks) numpy lists. Returns the
    global loss (on the device)."""
    from ..ops.helpers import bn_sync
    inputs, labels, fms, lms = batch
    n, r = comm.size, comm.rank
    t0 = time.perf_counter()
    scales = _weights(labels, lms, r, n)
    ins = _tensors(net, _shard(inputs, r, n))
    labs = _tensors(net, _shard(labels, r, n))
    fm = _tensors(net, _shard(fms, r, n))
    lm = _tensors(net, _shard(lms, r, n))
    with bn_sync(comm):
        loss, grads, new_vars = _grads(net, ins, labs, fm, lm, scales,
                                       with_reg=(r == 0))
    flat = _leaves(grads) + [loss.reshape(1)]
    summed = _all_reduce_flat(comm, flat)
    it = iter(summed)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [fill(v) for v in tree]
        return next(it)
    grads = fill(grads)
    loss = summed[-1].reshape(()).float()
    net._graphs.set_row(net._row_values(net.step))
    net._update_(grads, zero=None if net._zero is None
                 else (net._zero, comm))
    if net._zero is not None:
        from .zero import updater_state_bytes_per_device
        STATS["updater_state_bytes"] = float(
            updater_state_bytes_per_device(net))
    net._assign_variables(new_vars)
    net.step += 1
    net._score_raw = loss
    if net.device.type == "cuda":
        torch.cuda.synchronize(net.device)
    STATS["step_s"] = time.perf_counter() - t0
    return loss


def _pa_round(net, comm, batch, n_local: int) -> torch.Tensor:
    """One parameter-averaging round on this rank: ``batch`` = (xs, ys,
    fs, ls) lists of [n_dev, n_local, b, ...] arrays (fs None or a list,
    ls the loss weights). Returns the round's example-weighted loss."""
    xs, ys, fs, ls = batch
    r, n = comm.rank, comm.size
    graph = _is_graph(net)
    step = net.step
    dev = net.device
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    w_acc = 0.0
    for i in range(n_local):
        w = sum(float(np.asarray(m[r, i]).sum()) for m in ls)
        if w <= 0:
            continue  # a minibatch of fill rows only is a true no-op
        ins = [net._as_tensor(a[r, i]) for a in xs]
        labs = [net._as_tensor(a[r, i]) for a in ys]
        lms = [net._as_tensor(m[r, i]) for m in ls]
        fms = ([net._as_tensor(m[r, i]) if m is not None else None
                for m in fs] if fs is not None else None)
        row = net._row_values(step)
        if graph:
            fmd = (dict(zip(net.conf.network_inputs, fms))
                   if fms is not None else None)
            loss, _ = net._run("step", (ins, labs, fmd, lms, None),
                               net._step_body, row)
        else:
            loss, _ = net._run("step", (ins[0], labs[0],
                                        fms[0] if fms else None, lms[0],
                                        None), net._step_body, row)
        loss_acc = loss_acc + loss.float() * w
        w_acc += w
        step += 1
    tensors = _leaves(_state_tree(net))
    sums = torch.stack([loss_acc,
                        torch.tensor(w_acc, dtype=torch.float32,
                                     device=dev)])
    summed = _all_reduce_flat(comm, tensors + [sums])
    from ..nn.step_graph import copy_into
    with torch.no_grad():
        for t, s in zip(tensors, summed[:-1]):
            copy_into(t, s / n)
    tot = summed[-1]
    net.step += n_local
    loss = tot[0] / torch.clamp_min(tot[1], 1.0)
    net._score_raw = loss
    return loss


def _eval_counts(net, comm, batch, n_classes: int) -> torch.Tensor:
    """The confusion counts [C, C] of this rank's shard, summed over the
    ranks (JAX evaluation.py `_get_counts_fn`)."""
    inputs, labels, fms, lms = batch
    r, n = comm.rank, comm.size
    with torch.no_grad():
        out = _eval_output(net, _tensors(net, _shard(inputs, r, n)),
                           _tensors(net, _shard(fms, r, n)))
        y = net._as_tensor(_shard(labels, r, n)[0])
        w = net._as_tensor(_shard(lms, r, n)[0]).reshape(-1).float()
        if out.ndim == 3:
            out = out.reshape(-1, out.shape[-1])
            y = y.reshape(-1, y.shape[-1])
        eye = torch.eye(n_classes, dtype=torch.float32, device=out.device)
        oh_a = eye[torch.argmax(y, dim=-1)] * w[:, None]
        counts = oh_a.T @ eye[torch.argmax(out, dim=-1)]
    return _all_reduce_flat(comm, [counts])[0]


def _eval_output(net, ins, fms):
    if _is_graph(net):
        fmd = (dict(zip(net.conf.network_inputs, fms))
               if fms is not None else None)
        acts, _ = net._forward_impl(net.params, ins, fmasks=fmd)
        return acts[net.conf.network_outputs[0]]
    acts = net._forward_impl(net.params, net.variables, ins[0], train=False,
                             fmask=fms[0] if fms else None)[0]
    return acts[-1]


def _score(net, comm, batch) -> torch.Tensor:
    """The batch's masked-mean loss plus regularization, from the ranks'
    shards (JAX evaluation.py `_get_score_fn`)."""
    inputs, labels, fms, lms = batch
    r, n = comm.rank, comm.size
    scales = _weights(labels, lms, r, n)
    with torch.no_grad():
        ins = _tensors(net, _shard(inputs, r, n))
        fm = _tensors(net, _shard(fms, r, n))
        labs = _tensors(net, _shard(labels, r, n))
        lm = _tensors(net, _shard(lms, r, n))
        if _is_graph(net):
            fmd = (dict(zip(net.conf.network_inputs, fm))
                   if fm is not None else None)
            acts, _ = net._forward_impl(net.params, ins, fmasks=fmd)
            loss = net._loss(acts, labs, lm, scales=scales)
        else:
            acts = net._forward_impl(net.params, net.variables, ins[0],
                                     train=False,
                                     fmask=fm[0] if fm else None)[0]
            loss = net._loss_from_output(acts[-1], labs[0],
                                         lm[0] if lm else None) * scales[0]
        if r == 0:
            loss = loss + net._reg_loss(net.params)
    return _all_reduce_flat(comm, [loss.float().reshape(1)])[0][0]


class _Replica:
    """A follower's training replica (the service `_Ranks` attaches):
    the caller's net rebuilt from its configuration on the rank's
    device, kept in step with rank 0 by the same updates."""

    def __init__(self, comm, p):
        self.comm = comm
        if p["graph"]:
            from ..nn.graph import ComputationGraph
            net = ComputationGraph(p["conf"], device=comm.device,
                                   train_graphs=p["train_graphs"])
        else:
            from ..nn.multilayer import MultiLayerNetwork
            net = MultiLayerNetwork(p["conf"], device=comm.device,
                                    train_graphs=p["train_graphs"])
        self.net = net.init()

    def handle(self, cmd) -> None:
        data = pickle.loads(self.comm.broadcast_bytes(None, cmd.args[0]))
        op = cmd.op
        if op == OP_SYNC:
            _load_state(self.net, data, _data_comm(self.comm).rank)
        elif op == OP_ICI_STEP:
            _ici_step(self.net, _data_comm(self.comm), data)
        elif op == OP_ZERO_GATHER:
            self.net._zero.gather_whole(self.net, _data_comm(self.comm))
        elif op == OP_PA_ROUND:
            _pa_round(self.net, self.comm, data, cmd.args[1])
        elif op == OP_EVAL:
            _eval_counts(self.net, self.comm, data, cmd.args[1])
        elif op == OP_SCORE:
            _score(self.net, self.comm, data)
        else:
            raise ValueError(f"unknown trainer command {op}")

    def close(self) -> None:
        self.net = None


def _replica(comm, p) -> _Replica:
    return _Replica(comm, p)


class _Ranks:
    """The driver's side: the mesh and the replica of one net on its
    followers (re-attached when the net changes or the mesh restarts)."""

    def __init__(self, mesh: ProcessMesh):
        self.mesh = mesh
        self._net_id = None
        self._sid = 0
        self._starts = -1
        self.owned = False  # started here: `close` stops the followers
        self.borrowed = False  # the sid is a tp net's service

    def prepare(self, net) -> None:
        """Start the followers, build the net's replicas if needed, and
        hand them rank 0's state and step. A tensor-parallel net on this
        mesh trains through its own service (its ranks hold their
        slices); on another mesh it raises."""
        dev = net.device
        if self.mesh.device != dev:
            raise ValueError(f"the mesh's rank 0 runs on {self.mesh.device}, "
                             f"the net lives on {dev}")
        tp = net._tp
        if tp is not None:
            if tp.mesh is not self.mesh:
                raise ValueError("a tensor-parallel net trains under a master "
                                 "on the mesh it was sharded over")
            if self._sid and not self.borrowed:
                self.mesh.detach(self._sid)
            self._sid, self.borrowed = tp.sid, True
            self._net_id, self._starts = id(net), self.mesh.starts
            # the ranks hold their slices; they take the net's step
            step = int(net.step)
            self.run(OP_SYNC, {"step": step},
                     lambda: setattr(tp.graph, "step", step))
            return
        if self.borrowed:
            self._sid, self.borrowed, self._net_id = 0, False, None
        if self.mesh.size == 1:
            return
        if not self.mesh.alive():
            if self._sid and self._starts == self.mesh.starts:
                # a follower of the replicas' mesh died mid-job: the job
                # fails here, as JAX's does at its next collective, and
                # restarts on the ranks left from its last checkpoint
                # (statetracker.fit_with_recovery)
                raise MeshError("a follower of the training mesh died; "
                                "restart the job from its checkpoint")
            self.owned = True
        self.mesh.start()
        if self._net_id != id(net) or self._starts != self.mesh.starts:
            if self._sid and self._starts == self.mesh.starts:
                self.mesh.detach(self._sid)
            self._sid = self.mesh.attach(
                "deeplearning4j_tpu_torch.parallel.trainer:_replica",
                {"graph": _is_graph(net), "conf": net.conf,
                 "train_graphs": net.train_graphs})
            self._net_id = id(net)
            self._starts = self.mesh.starts
        self.run(OP_SYNC, _state_payload(net), lambda: None)

    def run(self, op: int, data, fn, arg: int = 0):
        """Broadcast ``op`` with ``data`` (one command, one data
        broadcast), then run ``fn()`` here: every rank runs its part."""
        if self.mesh.size == 1:
            return fn()
        blob = pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)
        with self.mesh.exclusive():
            self.mesh.command(op, self._sid, (len(blob), arg))
            self.mesh.broadcast_bytes(blob, len(blob))
            return fn()

    def close(self) -> None:
        """Drop the replicas; stop the followers where this started
        them."""
        if self.owned:
            self.mesh.close()
        elif self._sid and not self.borrowed:
            self.mesh.detach(self._sid)
        self._sid = 0
        self.borrowed = False
        self._net_id = None
        self.owned = False


def _mesh_for(mesh, net=None) -> ProcessMesh:
    if mesh is not None:
        return mesh
    if net is not None and net.device.type == "cpu":
        return default_mesh(1, ["cpu"])
    return default_mesh()


class IciDataParallelTrainingMaster(TrainingMaster):
    """A gradient all-reduce every step (see the module docstring).
    ``mesh``: a `parallel.mesh.ProcessMesh` whose rank 0 runs on the
    net's device (default: every card; a CPU net without a mesh trains in
    one rank)."""

    def __init__(self, mesh: Optional[ProcessMesh] = None,
                 collect_stats: bool = False, state_tracker=None):
        self.mesh = mesh
        self.stats = SparkTrainingStats() if collect_stats else None
        # fault tolerance: periodic atomic checkpoints (statetracker.py)
        self.state_tracker = state_tracker
        self._ranks: Optional[_Ranks] = None
        self._batches_done = 0
        self._skip = 0
        self._zero_net = None  # a ZeRO-1 net whose slices the ranks hold

    def resume(self, net) -> int:
        """Restore the newest checkpoint into ``net`` (the driver's) and
        return how many leading batches of the SAME data sequence
        `execute_training` skips (JAX :167; the redelivery of
        StateTracker.java:122-129); the followers take the restored state
        at once (`_prepare`: one ``OP_SYNC``)."""
        if self.state_tracker is None:
            return 0
        cursor = self.state_tracker.restore(net) or {}
        skip = int(cursor.get("master_batches", 0))
        self._batches_done = skip
        self._skip = skip
        self._prepare(net)
        return skip

    def _prepare(self, net) -> _Ranks:
        net._check_init()
        if self._ranks is None:
            self.mesh = _mesh_for(self.mesh, net)
            self._ranks = _Ranks(self.mesh)
        self._ranks.prepare(net)
        return self._ranks

    def execute_training(self, net, iterator) -> None:
        ranks = self._prepare(net)
        comm = ranks.mesh
        # the batch is padded to a multiple of the whole mesh (JAX :199,
        # :217-218) and split over its data axis
        n_dev = comm.size
        data = _data_comm(comm)
        tp = net._tp
        target = net if tp is None else tp.graph
        if net._zero is not None:
            net._zero.bind(ranks)
            self._zero_net = net
        # a resumed run skips the batches trained before the restored
        # checkpoint (the iterator replays the same sequence)
        skip, self._skip = self._skip, 0
        for ds in iterator:
            if skip > 0:
                skip -= 1
                continue
            with phase_timer(self.stats, "data_fetch"):
                inputs, labels, fms, lms = _as_lists(ds)
                inputs = [_np(a) for a in inputs]
                labels = [_np(a) for a in labels]
                fms = [_np(m) for m in fms] if fms is not None else None
                lms = [_np(m) for m in lms] if lms is not None else None
                batch = _pad_ragged(inputs, labels, fms, lms, n_dev)
            with phase_timer(self.stats, "process_minibatch"):
                ranks.run(OP_ICI_STEP, batch,
                          lambda: _ici_step(target, data, batch))
                if tp is not None:
                    tp.stepped()
                    net.step = target.step
                    net._score_raw = target._score_raw
                elif net._zero is not None:
                    net._zero.stepped()
            for listener in net.listeners:
                listener.iteration_done(net, net.step)
            self._batches_done += 1
            if self.state_tracker is not None:
                self.state_tracker.batch_done(
                    net, {"master_batches": self._batches_done})
        if self.state_tracker is not None:
            # async trackers: the last checkpoint durable (and a writer
            # error raised) before the call returns
            self.state_tracker.wait()

    def get_training_stats(self):
        return self.stats

    def close(self) -> None:
        net, self._zero_net = self._zero_net, None
        if net is not None and net._zero is not None \
                and net._zero.ranks is self._ranks:
            # the followers' slices come home before they stop
            net._zero.whole(net)
            net._zero.pending = net._zero.full
            net._zero.ranks = None
        if self._ranks is not None:
            self._ranks.close()


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Reference-semantics parameter averaging
    (ParameterAveragingTrainingMaster.java:50): each rank is a worker
    with its own parameter copy; every ``averaging_frequency`` minibatches
    of ``batch_size_per_worker`` the parameters, variables and updater
    state are averaged (see the module docstring)."""

    def __init__(self, batch_size_per_worker: int = 16,
                 averaging_frequency: int = 1,
                 mesh: Optional[ProcessMesh] = None,
                 collect_stats: bool = False, state_tracker=None):
        self.batch_size_per_worker = int(batch_size_per_worker)
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.mesh = mesh
        self.stats = SparkTrainingStats() if collect_stats else None
        self.state_tracker = state_tracker
        self._ranks: Optional[_Ranks] = None
        self._rounds_done = 0
        self._batches_done = 0
        self._skip = 0

    def resume(self, net) -> int:
        """As `IciDataParallelTrainingMaster.resume`: restore into the
        driver's net, re-sync the followers, and return the batches to
        skip (the checkpoint's ``master_batches``: a checkpoint is only
        written where no rows are carried into the next round)."""
        if self.state_tracker is None:
            return 0
        cursor = self.state_tracker.restore(net) or {}
        self._rounds_done = int(cursor.get("round", 0))
        skip = int(cursor.get("master_batches", 0))
        self._batches_done = skip
        self._skip = skip
        self._prepare(net)
        return skip

    def _prepare(self, net) -> _Ranks:
        net._check_init()
        if self._ranks is None:
            self.mesh = _mesh_for(self.mesh, net)
            self._ranks = _Ranks(self.mesh)
        self._ranks.prepare(net)
        return self._ranks

    def execute_training(self, net, iterator) -> None:
        ranks = self._prepare(net)
        comm = ranks.mesh
        n_dev = comm.size
        b = self.batch_size_per_worker
        n = self.averaging_frequency
        buf: List[tuple] = []

        def have():
            return sum(t[0][0].shape[0] for t in buf)

        def _concat_masks(pos: int, batches, ref_col):
            present = [t[pos][ref_col] for t in batches
                       if t[pos] is not None and t[pos][ref_col] is not None]
            if not present:
                return None
            template = np.asarray(present[0])
            out = []
            for t in batches:
                m = t[pos][ref_col] if t[pos] is not None else None
                nrows = t[0][0].shape[0]
                if m is None:
                    m = np.ones((nrows,) + template.shape[1:], np.float32)
                out.append(np.asarray(m, np.float32))
            return np.concatenate(out)

        def flush():
            if not buf:
                return
            n_in = len(buf[0][0])
            n_out = len(buf[0][1])
            batches = list(buf)
            buf.clear()
            inputs = [np.concatenate([t[0][k] for t in batches])
                      for k in range(n_in)]
            labels = [np.concatenate([t[1][k] for t in batches])
                      for k in range(n_out)]
            fms = [_concat_masks(2, batches, k) for k in range(n_in)]
            has_fm = any(m is not None for m in fms)
            lms = [_concat_masks(3, batches, k) for k in range(n_out)]
            need = n_dev * n * b
            orig = inputs[0].shape[0]

            def fill(a):
                # a partial round: cyclic duplicates, zero-weighted and
                # spread round-robin below so that no worker idles
                reps = int(np.ceil(need / orig))
                return np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:need]

            if orig < need:
                inputs = [fill(a) for a in inputs]
                labels = [fill(a) for a in labels]
                fms = [fill(m) if m is not None else None for m in fms]
                lms = [fill(m) if m is not None else None for m in lms]
            elif orig > need:  # carry the remainder into the next round
                buf.append(([a[need:] for a in inputs],
                            [a[need:] for a in labels],
                            [m[need:] if m is not None else None for m in fms]
                            if has_fm else None,
                            [m[need:] if m is not None else None for m in lms]
                            if any(m is not None for m in lms) else None))
                inputs = [a[:need] for a in inputs]
                labels = [a[:need] for a in labels]
                fms = [m[:need] if m is not None else None for m in fms]
                lms = [m[:need] if m is not None else None for m in lms]
            lmasks = []
            for y, m in zip(labels, lms):
                w = _ones_lmask(y, need, orig)
                if m is not None:
                    w = w * np.asarray(m, np.float32).reshape(w.shape)
                lmasks.append(w)
            if orig < need:
                # row i -> worker i % n_dev: real rows land on every worker
                perm = np.arange(need).reshape(n * b, n_dev).T.reshape(-1)
                inputs = [a[perm] for a in inputs]
                labels = [a[perm] for a in labels]
                lmasks = [m[perm] for m in lmasks]
                fms = [m[perm] if m is not None else None for m in fms]

            def stack(a):
                return a.reshape((n_dev, n, b) + a.shape[1:])
            batch = ([stack(a) for a in inputs], [stack(a) for a in labels],
                     ([stack(m) if m is not None else None for m in fms]
                      if has_fm else None),
                     [stack(m) for m in lmasks])
            with phase_timer(self.stats, "aggregate_round"):
                ranks.run(OP_PA_ROUND, batch,
                          lambda: _pa_round(net, comm, batch, n), arg=n)
            for listener in net.listeners:
                listener.iteration_done(net, net.step)
            self._rounds_done += 1
            if self.state_tracker is not None and not buf:
                self.state_tracker.batch_done(
                    net, {"round": self._rounds_done,
                          "master_batches": self._batches_done})

        skip, self._skip = self._skip, 0
        with phase_timer(self.stats, "total_training"):
            for ds in iterator:
                if skip > 0:
                    skip -= 1
                    continue
                self._batches_done += 1
                with phase_timer(self.stats, "data_fetch"):
                    inputs, labels, bfm, blm = _as_lists(ds)
                    buf.append(([_np(a) for a in inputs],
                                [_np(a) for a in labels],
                                [_np(m) for m in bfm] if bfm else None,
                                [_np(m) for m in blm] if blm else None))
                if have() >= n_dev * n * b:
                    flush()
            while buf:
                flush()
        if self.state_tracker is not None:
            self.state_tracker.wait()

    def get_training_stats(self):
        return self.stats

    def close(self) -> None:
        if self._ranks is not None:
            self._ranks.close()


class ParallelWrapper:
    """Multi-rank data parallelism over one net (reference
    parallelism/ParallelWrapper.java: N trainers with model clones,
    averaging every ``averaging_frequency`` iterations :95): a
    `ParameterAveragingTrainingMaster` over ``workers`` ranks (on the
    first cards, or CPU ranks for a CPU net), the iterator prefetched."""

    def __init__(self, net, workers: Optional[int] = None,
                 averaging_frequency: int = 1,
                 batch_size_per_worker: int = 32,
                 prefetch_buffer: int = 2,
                 mesh: Optional[ProcessMesh] = None):
        self.net = net
        if mesh is None:
            n = workers or (torch.cuda.device_count()
                            if net.device.type == "cuda" else 1)
            mesh = default_mesh(n, ["cpu"] * n
                                if net.device.type == "cpu" else None)
        self.master = ParameterAveragingTrainingMaster(
            batch_size_per_worker=batch_size_per_worker,
            averaging_frequency=averaging_frequency, mesh=mesh)
        self.prefetch_buffer = prefetch_buffer

    def fit(self, iterator):
        from ..datasets.iterators import AsyncDataSetIterator
        if self.prefetch_buffer > 0:
            iterator = AsyncDataSetIterator(iterator, self.prefetch_buffer)
        self.master.execute_training(self.net, iterator)
        return self.net

    def close(self) -> None:
        self.master.close()
