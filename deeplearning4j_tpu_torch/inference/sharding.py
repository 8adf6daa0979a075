"""Tensor-parallel decode — port of deeplearning4j_tpu/inference/sharding.py.

The plan is the JAX package's: the Megatron pairing of
`parallel/tensor_parallel._tp_specs_for_graph` with every output vertex
replicated (`decode_param_specs`):

  - attention Wq/Wk/Wv split by column (heads), Wo by row, ``b``
    replicated — one all-reduce per attention block;
  - the FFN up-projection split by column with its bias, the
    down-projection by row — one all-reduce per FFN;
  - embeddings, LayerNorms and the output head replicated;
  - the KV cache (contiguous stripes, paged pages and int8 scale pages)
    split on its Hkv head axis (`state_shardings`): each rank holds its
    heads' rows, so at a fixed per-rank budget the pool holds ``tp×`` the
    blocks (`kvpool.KVPool`'s ``shard_factor``); positions, block tables
    and the recurrent h/c rows are replicated on the host.

The mechanism is the port's own (`parallel/mesh.py`): the engine's
process is rank 0 and drives followers that hold the other shards. Each
rank runs the same layer code on its local heads and hidden units
(`shard_graph`: a copy of the graph whose sharded layers carry the local
widths and the rank's communicator); a row-split layer all-reduces its
partial product and then adds its replicated bias once. The paged kernel
needs no variant: each rank calls it at its local H/tp and Hkv/tp.

In place of the JAX package's audit of compiled HLO, every collective is
counted (`parallel.mesh.COUNTS`): `collective_counts` runs one decode
step (or a speculating engine's verify or draft step:
`verify_collective_counts`, `draft_collective_counts`) and reports each
rank's calls, and `assert_hot_path_collectives`
holds them to the Megatron budget — two all-reduces a transformer block,
no data broadcast or gather, one command broadcast.
"""
from __future__ import annotations

import copy
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..parallel.mesh import ProcessMesh
from ..parallel.tensor_parallel import Spec, _tp_specs_for_graph

TP_AXIS = "tp"

REDUCE_COLLECTIVES = ("all_reduce",)
RESHARD_COLLECTIVES = ("all_gather", "broadcast_data")
COMMAND_COLLECTIVES = ("broadcast_command",)
ALL_COLLECTIVES = REDUCE_COLLECTIVES + RESHARD_COLLECTIVES \
    + COMMAND_COLLECTIVES

# state keys split on the head axis (axis 2): contiguous K/V rows
# [n_slots, L, Hkv, Dh], pages [pages, block, Hkv, Dh], int8 scale pages
# [pages, block, Hkv]
HEAD_KEYS = ("k", "v", "k_pages", "v_pages", "k_scales", "v_scales")


def decode_mesh(n_devices: int, devices: Optional[Sequence] = None,
                axis: str = TP_AXIS, timeout: float = 300.0) -> ProcessMesh:
    """1-D ``tp`` mesh of ``n_devices`` ranks (default devices ``cuda:0``
    .. ``cuda:n-1``; see `parallel.mesh.ProcessMesh`). The serving CLI's
    ``--tp N`` resolves through here."""
    return ProcessMesh(n_devices, devices, axis=axis, timeout=timeout)


def decode_param_specs(conf, axis: str = TP_AXIS) -> Dict[str, Dict[str, Spec]]:
    """Per-vertex specs for decode: the training plan with every output
    vertex replicated (a column-split softmax head would put a gather of
    the distribution on every token)."""
    specs = _tp_specs_for_graph(conf, axis)
    for out in conf.network_outputs:
        specs[out] = {}
    return specs


def _tp_of(mesh: Union[int, ProcessMesh], axis: str) -> int:
    if isinstance(mesh, int):
        return mesh
    return int(mesh.shape.get(axis, 1))


def effective_specs(net, tp: int, specs=None, axis: str = TP_AXIS
                    ) -> Dict[str, Dict[str, Spec]]:
    """``specs`` (default `decode_param_specs`) with every param dim that
    ``tp`` does not divide replicated, with a warning, as JAX
    `shard_decode_params` does (:101-112)."""
    specs = decode_param_specs(net.conf, axis) if specs is None else specs
    out: Dict[str, Dict[str, Spec]] = {}
    for name, lp in net.params.items():
        vs = {}
        for pname, arr in lp.items():
            spec = tuple(specs.get(name, {}).get(pname, ()))
            for d, ax in enumerate(spec):
                if ax is not None and arr.shape[d] % tp:
                    warnings.warn(
                        f"shard_decode_params: {name}/{pname} dim {d} (size "
                        f"{arr.shape[d]}) is not divisible by mesh axis "
                        f"'{ax}' ({tp}); replicating this param",
                        stacklevel=3)
                    spec = ()
                    break
            vs[pname] = spec
        out[name] = vs
    return out


def _slice(arr: torch.Tensor, spec: Spec, tp: int, rank: int) -> torch.Tensor:
    for d, ax in enumerate(spec):
        if ax is not None:
            n = arr.shape[d] // tp
            arr = arr.narrow(d, rank * n, n)
    return arr.detach().clone()


def shard_decode_params(net, mesh: Union[int, ProcessMesh], rank: int = 0,
                        axis: str = TP_AXIS, specs=None
                        ) -> Tuple[Dict, Dict]:
    """(rank ``rank``'s params, replicated variables) as new tensors; the
    net is never touched. ``mesh``: a mesh with a ``tp`` axis, or the tp
    size. A dim ``tp`` does not divide warns and replicates."""
    tp = _tp_of(mesh, axis)
    eff = effective_specs(net, tp, specs, axis)
    params = {name: {pname: _slice(arr, eff[name][pname], tp, rank)
                     for pname, arr in lp.items()}
              for name, lp in net.params.items()}
    variables = {name: {k: v.detach().clone() for k, v in lv.items()}
                 for name, lv in net.variables.items()}
    return params, variables


def state_shardings(states, axis: str = TP_AXIS):
    """The spec of each of the engine's carried state tensors: K/V rows,
    pages and int8 scale pages split on the head axis 2, everything else
    (positions, recurrent h/c) replicated."""
    head = (None, None, axis)
    out = {}
    for key, st in states.items():
        if isinstance(st, dict) and (("k" in st and "v" in st)
                                     or "k_pages" in st):
            out[key] = {k: (head if k in HEAD_KEYS else ()) for k in st}
        else:
            out[key] = {k: () for k in st}
    return out


def storage_shardings(storage, axis: str = TP_AXIS):
    """The contiguous side pool's storage ({layer: {"k"/"v": [n_blocks,
    block, Hkv, Dh]}}): split on the head axis like the stripes, so a
    restore's block copy never crosses ranks."""
    head = (None, None, axis)
    return {name: {kv: head for kv in st} for name, st in storage.items()}


def kv_heads_shardable(kv_heads: Dict[str, int], tp: int) -> bool:
    """True when every attention layer's Hkv divides by ``tp`` — the
    head-split cache cannot split a head."""
    return bool(kv_heads) and all(h % tp == 0 for h in kv_heads.values())


# -- the rank's shard graph ------------------------------------------------
def shard_modes(conf, eff: Dict[str, Dict[str, Spec]]) -> Dict[str, str]:
    """How each sharded vertex runs: "heads" (attention over local heads,
    all-reduce after Wo), "heads_kv" (the same with K/V whole on every
    rank: a GQA whose Wk/Wv the plan replicated, which only training
    meets — the decode engine refuses such a net), "col" (local hidden
    units), "col_gather" (local units gathered back: a consumer that is
    not row-split, or a network output — a resharding), "row" (partial
    product, all-reduce)."""
    from ..nn.conf.graph import LayerVertex
    from ..nn.conf.layers import SelfAttentionLayer
    modes: Dict[str, str] = {}
    for name, vs in eff.items():
        v = conf.vertices[name]
        if not isinstance(v, LayerVertex):
            continue
        if isinstance(v.layer, SelfAttentionLayer):
            if vs.get("Wq", ()) != () and vs.get("Wo", ()) != ():
                modes[name] = ("heads" if vs.get("Wk", ()) != ()
                               else "heads_kv")
        elif "W" in vs and len(vs["W"]) == 2:
            if vs["W"][1] is not None:
                modes[name] = "col"
            elif vs["W"][0] is not None:
                modes[name] = "row"
    for name, mode in list(modes.items()):
        if mode != "col":
            continue
        consumers = [v for v, srcs in conf.vertex_inputs.items()
                     if name in srcs]
        if name in conf.network_outputs or not consumers or any(
                modes.get(c) != "row" for c in consumers):
            modes[name] = "col_gather"
    return modes


def shard_conf(conf, modes: Dict[str, str], tp: int):
    """A copy of ``conf`` whose sharded layers carry the rank's local
    widths (heads, hidden units, inputs)."""
    conf = copy.deepcopy(conf)
    for name, mode in modes.items():
        layer = conf.vertices[name].layer
        if mode in ("heads", "heads_kv"):
            layer.n_heads //= tp
            if getattr(layer, "n_kv_heads", None) and mode == "heads":
                layer.n_kv_heads //= tp
            layer.n_out //= tp
        elif mode in ("col", "col_gather"):
            layer.n_out //= tp
        elif mode == "row":
            layer.n_in //= tp
    return conf


def shard_graph(conf, modes: Dict[str, str], tp: int, params, variables,
                device, comm):
    """The rank's graph: `shard_conf` over ``params`` (the rank's slices)
    on ``device``, each sharded layer holding ``comm`` (the rank's
    collectives: the partial products' all-reduce, the gather, and in
    training the inputs' `copy_to_tp`); its steps are eager."""
    from ..nn.graph import ComputationGraph
    g = ComputationGraph(shard_conf(conf, modes, tp), device=device,
                         train_graphs="off")
    g.params = {name: {k: v.to(device) for k, v in lp.items()}
                for name, lp in params.items()}
    g.variables = {name: {k: v.to(device) for k, v in lv.items()}
                   for name, lv in variables.items()}
    g._initialized = True
    for name, mode in modes.items():
        impl = g._impls[name]
        if mode in ("heads", "heads_kv", "row"):
            impl.tp_comm = comm
        if mode == "col_gather":
            impl.tp_gather = comm
        if mode != "row":
            impl.tp_copy = comm
        if mode == "heads_kv":
            impl.tp_kv = comm
    return g


# -- the collective budget -------------------------------------------------
def collective_counts(engine, program: str = "decode"
                      ) -> List[Dict[str, int]]:
    """Each rank's collective calls (rank order) during one dispatch of
    ``engine``'s ``program`` — "decode" (the step), "verify" or "draft"
    (a speculating engine's) — all slots idle, the smallest table bucket,
    run by the caller while the engine's scheduler is not running. A
    tp = 1 engine reports one rank of zeros."""
    return engine._collective_audit(program)


def verify_collective_counts(engine) -> List[Dict[str, int]]:
    """The speculative verify's counts (JAX `verify_program_hlo` :241):
    the chain is a wider T, so its budget is the decode step's, two
    all-reduces a block and one command."""
    return collective_counts(engine, "verify")


def draft_collective_counts(engine) -> List[Dict[str, int]]:
    """The draft step's counts (JAX `draft_program_hlo` :264): a prefix of
    the target's blocks under the same specs, so two all-reduces a draft
    block, no resharding, one command."""
    return collective_counts(engine, "draft")


def assert_hot_path_collectives(counts, n_blocks: int) -> None:
    """The budget of a per-token step, on every rank: no resharding
    collective (an all-gather or a data broadcast), at most the two
    Megatron all-reduces a transformer block, and one command
    broadcast."""
    for r, c in enumerate([counts] if isinstance(counts, dict) else counts):
        bad = {op: n for op in RESHARD_COLLECTIVES if (n := c.get(op, 0))}
        if bad:
            raise AssertionError(
                f"rank {r}: resharding collective(s) on the per-token hot "
                f"path: {bad} — a chosen split disagrees with the dataflow "
                "(see inference/sharding.py)")
        budget = 2 * n_blocks
        n_reduce = sum(c.get(op, 0) for op in REDUCE_COLLECTIVES)
        if n_reduce > budget:
            raise AssertionError(
                f"rank {r}: {n_reduce} all-reduces in the per-token step, "
                f"budget is {budget} (2 per transformer block)")
        n_cmd = sum(c.get(op, 0) for op in COMMAND_COLLECTIVES)
        if n_cmd > 1:
            raise AssertionError(
                f"rank {r}: {n_cmd} command broadcasts in one step, "
                "budget is 1")
