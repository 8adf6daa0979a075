"""ComputationGraph: DAG network runtime — port of deeplearning4j_tpu/nn/graph.py.

Inference: ``init`` (seeded `torch.Generator`), ``_forward_impl`` with
explicit per-layer states (the decode engine's entry) and ``output``.
Training: the train-mode forward (input dropout from a generator on the
graph's device, seeded by the config), the multi-output loss with the
fused from-logits path, l1/l2, autograd in place of `jax.value_and_grad`,
the per-layer updater step shared with MultiLayerNetwork
(nn/updater/apply.py: the new values written into the graph's own
tensors, the step's scalars read from a device row), ``fit_batch``,
``fit_scan``, ``fit_batch_accumulated``, the line-search solvers
(eager), and ``fit``, whose iterator is prefetched and fused into
``fit_scan`` chunks as in MultiLayerNetwork; ``score``, listeners, and
the flat views of params and updater state in the JAX flat order (layers
by sorted name, then params by sorted name, then updater state by sorted
name), the order of the model zip's ``coefficients.bin`` and
``updater.bin``. On the card each step replays the CUDA graph captured
for its key unless ``train_graphs="off"`` (nn/step_graph.py).

Vertices (JAX graph.py :99-171): layer (its input preprocessor first),
merge, element-wise, subset, preprocessor, scale, last time step and
duplicate to time series. A vertex inherits its inputs' feature mask
(several combined by their minimum) while its output keeps a time axis,
and drops it once time is gone; a duplicate-to-time-series vertex takes
its reference input's mask and time length; a last-time-step vertex
with ``mask_input`` gathers each row's last unmasked step on the device
(JAX :225-234). A layer with non-trainable variables (BatchNorm) keeps
them in ``variables`` ({vertex: {name: tensor}}, JAX :50): a train-mode
forward returns their new values, which every training path (the
captured step, ``fit_scan``, ``fit_batch_accumulated``, whose K
micro-batches carry them from one to the next, truncated BPTT) writes
into the graph's own tensors in place; the line-search solvers leave
them as they are, as the JAX graph does. As in JAX, a graph does not
fuse BatchNorm with the pool after it (only MultiLayerNetwork does).
``feed_forward`` gives every vertex's activation, ``output_single`` the
first output, ``clone`` a copy with fresh tensors on the same device.

Remat (``conf.remat``) checkpoints each layer vertex of the train-mode
forward but the loss path's output layer (nn/layers/base.remat_forward).
``rnn_time_step`` streams inputs through the recurrent vertices' h/c and
the attention layers' contiguous KV cache, kept between calls until
``rnn_clear_previous_state``. Truncated BPTT windows every time-series
input, label and mask by ``tbptt_fwd_length`` (2-d arrays go whole to
every window), one step a window, the recurrent states carried and
detached between windows (JAX graph.py :622). ``evaluate`` and
``evaluate_regression`` read the first output.

Precision (JAX graph.py :173-227, multilayer.py :42-60; nn/precision.py):
parameters are made at ``conf.dtype`` (float32, bfloat16 or float64) and
the forward runs at ``conf.compute_dtype`` when it is set (mixed
precision: f32 master weights cast to the compute dtype in the forward,
so autograd hands f32 gradients back to the masters), else at the
parameter dtype. Inputs and every vertex output are cast to the compute
dtype; losses and the regularisation sum are f32; ``output`` and
``score`` follow the compute dtype. An unsupported ``compute_dtype``
raises ValueError.

Data parallelism (parallel/trainer.py): the ICI master drives the train
step's pieces on every rank itself — `_grads_on` with the rank's loss
scale, one gradient all-reduce, `_update_` — eagerly, outside the
captured step; parameter averaging runs the captured step locally.
Tensor parallelism (parallel/tensor_parallel.py, ``_tp``): the training
calls run on every rank's graph of local widths, and ``params`` /
``updater_state`` read as the whole arrays, gathered when read after a
step. A rank's graph (``_tp_split``, ``_tp_comm``) keeps the step's
global sums over its split params: the l1/l2 term of the split weights
(`_reg_loss`) and the L2 norms of gradient normalization (`_update_`,
nn/updater/gradnorm.py) are all-reduced over the axis. ZeRO-1
(parallel/zero.py, ``_zero``): the updater state holds this rank's
slices, ``updater_state`` reads the whole, and the net trains under the
ICI master.

Parameters live on ``device`` (default "cuda"; it raises when no CUDA
device is present — pass device="cpu" to run on the CPU). The attention
layers run the port's flash or splash kernels there, f32 or bf16 by the
compute dtype (ops/helpers.attention), and the convolution layers the
port's conv kernel. ``rnn_time_step`` (and with it
``generate_transformer(use_cache=True)``) runs at any compute dtype,
with its KV cache at the compute dtype.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .conf.config import BACKPROP_TBPTT
from .conf.graph import (ComputationGraphConfiguration,
                         DuplicateToTimeSeriesVertex, ElementWiseVertex,
                         GraphVertex, LastTimeStepVertex, LayerVertex,
                         MergeVertex, PreprocessorVertex, ScaleVertex,
                         SubsetVertex)
from .layers.base import (BaseRecurrentImpl, LayerImpl, detach_states,
                          impl_for, materialize_rnn_states, remat_forward)
# importing the impl modules registers them: every layer kind builds in a
# graph, whatever else the process imported (JAX graph.py :33)
from .layers import attention as _attention  # noqa: F401
from .layers import convolution as _convolution  # noqa: F401
from .layers import feedforward as _feedforward  # noqa: F401
from .layers import normalization as _normalization  # noqa: F401
from .layers import pretrain as _pretrain  # noqa: F401
from .layers import recurrent as _recurrent  # noqa: F401
from .precision import (cast_floats, compute_dtype_of, dtype_of, host_array,
                        host_floats, input_dtype)
from .step_graph import (SGD_ALGOS, StepGraphs, algo_of, copy_into,
                         stack_on, to_device)
from .updater.apply import layer_scalars, update_layer_
from ..ops import losses as losses_mod
from ..util.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class ComputationGraph:
    # tensor parallelism (parallel/tensor_parallel.py): the driver's
    # TpTraining; on a rank's graph, its split params by layer and its
    # axis communicator. ZeRO-1 (parallel/zero.py): the plan.
    _tp = None
    _tp_split: Optional[Dict[str, set]] = None
    _tp_comm = None
    _zero = None

    def __init__(self, conf: ComputationGraphConfiguration, *,
                 device: DeviceLike = "cuda",
                 train_graphs: Optional[str] = None):
        self.conf = conf
        self.device = resolve_device(device)
        self.dtype = dtype_of(conf.conf)
        self.compute_dtype = compute_dtype_of(conf.conf)
        self.topo = conf.topological_order()
        self._impls: Dict[str, LayerImpl] = {
            name: impl_for(v.layer) for name, v in conf.vertices.items()
            if isinstance(v, LayerVertex)}
        self.params: Dict[str, Dict[str, Tensor]] = {}
        self.variables: Dict[str, Dict[str, Tensor]] = {}
        self.updater_state: Dict[str, Dict[str, Dict[str, Tensor]]] = {}
        self.step = 0
        self._score_raw: Any = float("nan")
        self.listeners: List[Any] = []
        # dropout masks: a generator on the graph's device, seeded by the conf
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(conf.conf.seed))
        self._rnn_state: Dict[str, Any] = {}
        # minibatches fused into one fit_scan by fit(iterator)
        self.scan_batches = 16
        # "on" (default): each step on the card is a captured CUDA graph
        self._graphs = StepGraphs(
            self.device, train_graphs, row_dtype=torch.float64
            if self.dtype == torch.float64 else torch.float32)
        self._initialized = False

    @property
    def train_graphs(self) -> str:
        return self._graphs.mode

    @property
    def params(self) -> Dict[str, Dict[str, Tensor]]:
        """{layer: {param: tensor}}; under tensor parallelism the whole
        arrays, gathered from the ranks when read after a step."""
        if self._tp is not None:
            self._tp.refresh(self)
        return self._params

    @params.setter
    def params(self, value) -> None:
        self._params = value

    @property
    def updater_state(self) -> Dict[str, Dict[str, Dict[str, Tensor]]]:
        """{layer: {param: {state: tensor}}}; the whole arrays under
        tensor parallelism and ZeRO-1 (gathered when read)."""
        if self._tp is not None:
            self._tp.refresh(self)
        elif self._zero is not None:
            return self._zero.whole(self)
        return self._updater_state

    @updater_state.setter
    def updater_state(self, value) -> None:
        self._updater_state = value

    def _distributed_changed(self) -> None:
        """The whole state was just set on the driver: hand it to the
        tensor-parallel ranks, or to ZeRO-1's slices."""
        if self._tp is not None:
            self._tp.push(self)
        elif self._zero is not None:
            self._zero.reslice(self)

    # -- init ------------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None
             ) -> "ComputationGraph":
        """Draw every layer's params, in sorted layer-name order, from
        ``generator`` (default: a CPU generator seeded with the config's
        seed), place them on the graph's device, and reset the variables
        and the updater state."""
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(int(self.conf.conf.seed))
        for name in sorted(self._impls):
            self.params[name] = self._impls[name].init_params(
                gen, self.dtype, self.device)
            self.variables[name] = self._impls[name].init_variables(
                self.dtype, self.device)
            updater = self.conf.vertices[name].layer.updater
            self.updater_state[name] = {
                pname: updater.init_state(p)
                for pname, p in self.params[name].items()}
        self.step = 0
        self._graphs.drop()
        self._initialized = True
        self._distributed_changed()
        return self

    def _check_init(self):
        if not self._initialized:
            self.init()

    @property
    def score_(self) -> float:
        """The last minibatch's loss; the train step keeps it on the
        device and it is copied to the host only when read."""
        v = self._score_raw
        if not isinstance(v, float):
            v = float(v)
            self._score_raw = v
        return v

    def _as_tensor(self, a) -> Optional[Tensor]:
        return to_device(a, self.device, input_dtype(self.dtype))

    def _as_tensors(self, arrays) -> Optional[List[Optional[Tensor]]]:
        if arrays is None:
            return None
        if not isinstance(arrays, (list, tuple)):
            arrays = [arrays]
        return [self._as_tensor(a) for a in arrays]

    # -- forward ---------------------------------------------------------------
    @staticmethod
    def _preprocess(proc, x, train, gen):
        return proc.preprocess_train(x, gen) if train else proc.preprocess(x)

    def _vertex_forward(self, name: str, vertex: GraphVertex,
                        inputs: List[Tensor], params, variables, *, train,
                        gen, mask, vmasks, timesteps, states, new_states,
                        new_vars, preouts):
        if isinstance(vertex, LayerVertex):
            impl = self._impls[name]
            x = inputs[0]
            if vertex.preprocessor is not None:
                x = self._preprocess(vertex.preprocessor, x, train, gen)
            ckpt = train and bool(self.conf.conf.remat)
            if isinstance(impl, BaseRecurrentImpl):
                y, st = remat_forward(impl, train=train, ckpt=ckpt,
                                      recurrent=True)(
                    params[name], x, (states or {}).get(name), gen, mask)
                new_states[name] = st
                return y
            if preouts is not None and hasattr(impl, "forward_with_preout"):
                # an output vertex on the loss path: keep its
                # pre-activation for the stable from-logits losses (no
                # remat: the loss consumes it at once)
                y, preouts[name] = impl.forward_with_preout(
                    params[name], x, train=train, gen=gen, mask=mask)
                return y
            y, nv = remat_forward(impl, train=train, ckpt=ckpt,
                                  recurrent=False)(
                params[name], x, variables.get(name, {}), gen, mask)
            if nv:
                new_vars[name] = nv
            return y
        if isinstance(vertex, MergeVertex):
            return torch.cat(inputs, dim=-1)
        if isinstance(vertex, ElementWiseVertex):
            op = vertex.op.lower()
            out = inputs[0]
            if op == "add":
                for a in inputs[1:]:
                    out = out + a
            elif op == "subtract":
                for a in inputs[1:]:
                    out = out - a
            elif op in ("product", "multiply"):
                for a in inputs[1:]:
                    out = out * a
            elif op in ("average", "avg"):
                out = sum(inputs) / float(len(inputs))
            elif op == "max":
                for a in inputs[1:]:
                    out = torch.maximum(out, a)
            else:
                raise ValueError(f"Unknown elementwise op '{vertex.op}'")
            return out
        if isinstance(vertex, SubsetVertex):
            return inputs[0][..., vertex.from_idx:vertex.to_idx + 1]
        if isinstance(vertex, PreprocessorVertex):
            return self._preprocess(vertex.preprocessor, inputs[0], train,
                                    gen)
        if isinstance(vertex, ScaleVertex):
            return inputs[0] * vertex.scale_factor
        if isinstance(vertex, LastTimeStepVertex):
            x = inputs[0]
            m = vmasks.get(vertex.mask_input)
            if m is None:
                return x[:, -1, :]
            # each row's last unmasked step, gathered on the device
            idx = torch.clamp((m > 0).sum(dim=1) - 1, min=0)
            return x.gather(1, idx.view(-1, 1, 1).expand(
                x.shape[0], 1, x.shape[2])).squeeze(1)
        if isinstance(vertex, DuplicateToTimeSeriesVertex):
            x = inputs[0]
            t = timesteps.get(vertex.reference_input)
            if t is None:
                raise ValueError("DuplicateToTimeSeries: unknown reference "
                                 f"input {vertex.reference_input}")
            return x[:, None, :].expand(x.shape[0], t, x.shape[-1])
        raise ValueError(f"Unknown vertex type {type(vertex).__name__}")

    def _forward_impl(self, params, inputs: Sequence[Tensor], *,
                      variables: Optional[Dict[str, Dict[str, Tensor]]] = None,
                      train: bool = False,
                      gen: Optional[torch.Generator] = None,
                      fmasks: Optional[Dict[str, Tensor]] = None,
                      states: Optional[Dict[str, Any]] = None,
                      want_preout: bool = False,
                      new_vars: Optional[Dict[str, Dict[str, Tensor]]] = None):
        """Topo-ordered DAG forward with explicit states (JAX graph.py:173)
        from ``variables`` (default: the graph's). Returns (dict name ->
        activation, new states of the stateful layers), plus a dict of the
        output vertices' pre-activations when ``want_preout`` (the loss
        path); the new variables of the layers that have them go into
        ``new_vars`` when given. Masks follow the module docstring's
        rules."""
        conf = self.conf
        dtype = self.compute_dtype
        if dtype != self.dtype:  # mixed precision: compute on cast masters
            params = cast_floats(params, dtype)
        if variables is None:
            variables = self.variables
        if new_vars is None:
            new_vars = {}
        acts: Dict[str, Tensor] = {}
        vmasks: Dict[str, Optional[Tensor]] = {}
        timesteps: Dict[str, int] = {}
        for i, iname in enumerate(conf.network_inputs):
            x = inputs[i]
            if x.is_floating_point() and x.dtype != dtype:
                x = x.to(dtype)
            acts[iname] = x
            vmasks[iname] = (fmasks or {}).get(iname)
            if x.ndim == 3:
                timesteps[iname] = x.shape[1]
        new_states: Dict[str, Any] = {}
        preouts: Dict[str, Tensor] = {}
        out_names = set(conf.network_outputs) if want_preout else set()
        for name in self.topo:
            srcs = conf.vertex_inputs[name]
            src_masks = [m for m in (vmasks.get(s) for s in srcs)
                         if m is not None]
            in_mask = src_masks[0] if src_masks else None
            for m in src_masks[1:]:
                in_mask = torch.minimum(in_mask, m)
            vertex = conf.vertices[name]
            y = self._vertex_forward(
                name, vertex, [acts[s] for s in srcs], params, variables,
                train=train, gen=gen, mask=in_mask, vmasks=vmasks,
                timesteps=timesteps, states=states, new_states=new_states,
                new_vars=new_vars,
                preouts=preouts if name in out_names else None)
            if y.is_floating_point() and y.dtype != dtype:
                y = y.to(dtype)  # stop f32 creep under mixed precision
            acts[name] = y
            if isinstance(vertex, DuplicateToTimeSeriesVertex):
                vmasks[name] = vmasks.get(vertex.reference_input)
            else:
                vmasks[name] = in_mask if y.ndim == 3 else None
            if y.ndim == 3:
                timesteps[name] = y.shape[1]
        if want_preout:
            return acts, new_states, preouts
        return acts, new_states

    # -- loss ------------------------------------------------------------------
    def _loss(self, acts: Dict[str, Tensor], labels: Sequence[Tensor],
              lmasks: Optional[Sequence[Optional[Tensor]]] = None,
              preouts: Optional[Dict[str, Tensor]] = None,
              scales: Optional[Sequence[float]] = None) -> Tensor:
        """Sum over the network outputs of each output layer's loss (JAX
        graph.py:240), from the pre-activation where the activation and
        loss pair has a fused from-logits form; ``scales``: a factor for
        each output's loss (a data-parallel rank's share of the global
        weight, parallel/trainer.py)."""
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, out_name in enumerate(self.conf.network_outputs):
            vertex = self.conf.vertices[out_name]
            layer_conf = vertex.layer if isinstance(vertex, LayerVertex) \
                else None
            loss_name = getattr(layer_conf, "loss", None) or "mse"
            fused = losses_mod.fused_from_logits(
                getattr(layer_conf, "activation", None), loss_name)
            if fused is not None and preouts and out_name in preouts:
                loss_fn, out = fused, preouts[out_name]
            else:
                loss_fn, out = losses_mod.get(loss_name), acts[out_name]
            y = labels[i]
            m = lmasks[i] if lmasks else None
            if out.ndim == 3:  # per-timestep output: flatten time
                out = out.reshape(-1, out.shape[-1])
                y = y.reshape(-1, y.shape[-1])
            li = loss_fn(y, out, None if m is None else m.reshape(-1))
            if scales is not None:
                li = li * scales[i]
            total = total + li.float()
        return total

    def _reg_loss(self, params) -> Tensor:
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        split = self._tp_split
        part = None
        for name, impl in self._impls.items():
            keys = split.get(name) if split else None
            if not keys or not impl.regularized():
                total = total + impl.reg_loss(params[name]).float()
                continue
            # a tensor-parallel rank: its split weights' term is summed
            # over the axis, the replicated ones' counted once
            total = total + impl.reg_loss(params[name], exclude=keys).float()
            term = impl.reg_loss(params[name], only=keys).float()
            part = term if part is None else part + term
        if part is not None:
            from ..parallel.tp_autograd import reduce_from_tp
            total = total + reduce_from_tp(self._tp_comm, part)
        return total

    # -- train step ------------------------------------------------------------
    def _masks_by_input(self, fmasks) -> Optional[Dict[str, Tensor]]:
        fm = self._as_tensors(fmasks)
        return None if fm is None else dict(zip(self.conf.network_inputs, fm))

    def compute_gradient_and_score(self, inputs, labels, fmasks=None,
                                   lmasks=None):
        """One train-mode forward and backward on a minibatch without
        updating anything: (loss, {layer: {param: gradient}}). The loss is
        the sum of the outputs' batch-mean losses plus regularization (JAX
        `_build_loss_fn`, graph.py :312). ``inputs``/``labels`` (and the
        masks): one array per network input/output, or a single array."""
        self._check_init()
        return self._grads_on(self._as_tensors(inputs),
                              self._as_tensors(labels),
                              self._masks_by_input(fmasks),
                              self._as_tensors(lmasks), None,
                              self.variables)[:2]

    def _grads_on(self, ins, labs, fmasks, lmasks, states, variables,
                  loss_scales=None, with_reg: bool = True):
        """(loss, gradients, the new variables, the recurrent vertices' new
        states): the train step's forward from ``states`` (None: zeros)
        and ``variables``, and its backward, on device tensors (``fmasks``
        by input name). ``loss_scales`` / ``with_reg``: a data-parallel
        rank's loss scales and whether it adds the regularization
        (parallel/trainer.py)."""
        params = {name: {k: v.detach().requires_grad_(True)
                         for k, v in lp.items()}
                  for name, lp in self.params.items()}
        new_vars = dict(variables)
        acts, new_states, preouts = self._forward_impl(
            params, ins, variables=variables, train=True, gen=self._gen,
            fmasks=fmasks, states=states, want_preout=True,
            new_vars=new_vars)
        loss = self._loss(acts, labs, lmasks, preouts, loss_scales)
        if with_reg:
            loss = loss + self._reg_loss(params)
        leaves = [p for lp in params.values() for p in lp.values()]
        flat = iter(torch.autograd.grad(loss, leaves, allow_unused=True)
                    if leaves else ())
        grads = {}
        for name, lp in params.items():
            grads[name] = {}
            for k, p in lp.items():
                g = next(flat)
                grads[name][k] = torch.zeros_like(p) if g is None else g
        return loss.detach(), grads, new_vars, new_states

    def _row_values(self, step: int) -> List[float]:
        """The scalars of step ``step`` for every layer with params, in
        the order the step body reads them (nn/updater/apply.py)."""
        vals: List[float] = []
        for name, lp in self.params.items():
            if lp:
                vals += layer_scalars(self.conf.vertices[name].layer,
                                      self.conf.conf,
                                      self._impls[name].WEIGHT_KEYS, lp, step)
        return vals

    def _state_tensors(self) -> List[Tensor]:
        """The tensors a step writes in place."""
        return ([t for lp in self.params.values() for t in lp.values()]
                + [t for lv in self.variables.values() for t in lv.values()]
                + [t for lu in self.updater_state.values()
                   for st in lu.values() for t in st.values()])

    @torch.no_grad()
    def _update_(self, grads, zero=None) -> None:
        """Every layer's update (JAX graph.py :275), in place, its
        scalars from the row. ``zero``: ZeRO-1's (plan, data
        communicator), which updates this rank's slices
        (nn/updater/apply.py)."""
        row = iter(self._graphs.row_views)
        split = self._tp_split or {}
        for name, lp in self._params.items():
            if grads[name]:
                update_layer_(self.conf.vertices[name].layer,
                              self._impls[name].WEIGHT_KEYS, lp, grads[name],
                              self._updater_state[name], row,
                              split=split.get(name, ()), comm=self._tp_comm,
                              zero=None if zero is None
                              else (zero[0].dims[name], zero[1]))

    @torch.no_grad()
    def _assign_variables(self, new_vars) -> None:
        for name, lv in self.variables.items():
            nv = new_vars.get(name, lv)
            if nv is not lv:
                for k, t in nv.items():
                    lv[k].copy_(t)

    def _step_body(self, ins, labs, fmasks, lmasks, states):
        """One optimization step on device tensors — what a capture
        records: (loss, the recurrent vertices' new states)."""
        loss, grads, new_vars, new_states = self._grads_on(
            ins, labs, fmasks, lmasks, states, self.variables)
        self._update_(grads)
        self._assign_variables(new_vars)
        return loss, detach_states(new_states)

    def _accum_body(self, xs, ys):
        """One update from the mean of K microbatch gradients (JAX
        `_build_accum_step`, graph.py :375), the variables carried from
        one microbatch to the next: the K losses."""
        k = xs[0].shape[0]
        variables, gsum, losses = self.variables, None, []
        for i in range(k):
            loss, grads, variables, _ = self._grads_on(
                [a[i] for a in xs], [a[i] for a in ys], None, None, None,
                variables)
            losses.append(loss)
            gsum = grads if gsum is None else {
                n: {p: gsum[n][p] + g for p, g in lg.items()}
                for n, lg in grads.items()}
        self._update_({n: {p: g / k for p, g in lg.items()}
                       for n, lg in gsum.items()})
        self._assign_variables(variables)
        return torch.stack(losses)

    def _run(self, tag, args, body, row):
        """One step of ``body`` on ``args`` with the scalars ``row`` (host
        values, or a device row), captured or eager (nn/step_graph.py)."""
        if self._zero is not None:
            from ..parallel.zero import refuse_own_step
            refuse_own_step()
        self._graphs.set_row(row)
        return self._graphs.run(tag, args, body, self._state_tensors(),
                                self._gen)

    def _update(self, loss):
        self._score_raw = loss
        self.step += 1
        for listener in self.listeners:
            listener.iteration_done(self, self.step)

    def fit_batch(self, inputs, labels, fmasks=None, lmasks=None):
        """``conf.iterations`` optimization steps (at least one) on one
        minibatch (JAX `_fit_one`, graph.py :589); the score stays on the
        device until read. A solver ``optimization_algo`` trains through
        optimize/solver.py; truncated BPTT windows a time series."""
        self._check_init()
        if self._tp is not None:
            self._tp.call(self, "fit_batch", inputs, labels, fmasks, lmasks)
            return
        algo = algo_of(self.conf.conf)
        ins, labs = self._as_tensors(inputs), self._as_tensors(labels)
        fms, lms = self._as_tensors(fmasks), self._as_tensors(lmasks)
        if (self.conf.backprop_type == BACKPROP_TBPTT
                and any(a.ndim == 3 for a in ins)):
            if algo not in SGD_ALGOS:
                raise NotImplementedError(
                    f"optimization_algo={algo!r} is not supported with "
                    "truncated BPTT; use stochastic_gradient_descent")
            self._do_truncated_bptt(ins, labs, fms, lms)
            return
        fmd = None if fms is None else dict(zip(self.conf.network_inputs,
                                                fms))
        if algo not in SGD_ALGOS:
            self._fit_one_solver(algo, ins, labs, fmd, lms)
            return
        for _ in range(max(1, self.conf.conf.iterations)):
            loss, _ = self._run("step", (ins, labs, fmd, lms, None),
                                self._step_body, self._row_values(self.step))
            self._update(loss)

    def _do_truncated_bptt(self, ins, labs, fms, lms):
        """One step per window of ``tbptt_fwd_length`` steps over the DAG
        (JAX graph.py :622): 3-d inputs and labels are windowed along time,
        and so is a mask whose array is a time series; anything else goes
        whole to every window. The recurrent vertices' states start at
        zeros and are carried and detached between windows; attention
        vertices run each window stateless."""
        T = max(a.shape[1] for a in ins if a.ndim == 3)
        L = self.conf.tbptt_fwd_length
        states = materialize_rnn_states(
            self._impls.items(), {}, ins[0].shape[0], self.compute_dtype,
            self.device, tbptt=True)

        def win(a, start, end, seq):
            return a[:, start:end] if (a is not None and seq
                                       and a.ndim >= 2) else a

        for start in range(0, T, L):
            end = min(start + L, T)
            fmd = None if fms is None else {
                name: win(m, start, end, ins[i].ndim == 3)
                for i, (name, m) in enumerate(zip(self.conf.network_inputs,
                                                  fms))}
            loss, states = self._run(
                "step", ([win(a, start, end, a.ndim == 3) for a in ins],
                         [win(y, start, end, y.ndim == 3) for y in labs], fmd,
                         None if lms is None else [
                             win(m, start, end, labs[i].ndim == 3)
                             for i, m in enumerate(lms)], states),
                self._step_body, self._row_values(self.step))
            self._update(loss)

    def fit_batch_accumulated(self, inputs, labels, accumulation_steps: int):
        """One optimizer step from ``accumulation_steps`` microbatch
        gradients, as one captured graph on the card (JAX graph.py :403;
        the batch axis of every input and label must divide evenly;
        unmasked). Returns the mean microbatch loss, on the device."""
        self._check_init()
        if self._tp is not None:
            return self._tp.call(self, "fit_batch_accumulated", inputs,
                                 labels, accumulation_steps)
        algo = algo_of(self.conf.conf)
        if algo not in SGD_ALGOS or self.conf.conf.iterations > 1:
            raise ValueError(
                "fit_batch_accumulated supports SGD-family training with "
                f"iterations=1 (got algo={algo!r}, "
                f"iterations={self.conf.conf.iterations})")
        k = int(accumulation_steps)
        if k <= 0:
            raise ValueError(f"accumulation_steps must be >= 1 (got {k})")
        ins, outs = self._as_tensors(inputs), self._as_tensors(labels)
        for a in ins + outs:
            if a.shape[0] % k:
                raise ValueError(f"batch {a.shape[0]} not divisible by "
                                 f"accumulation_steps {k}")

        def split(a):
            return a.reshape((k, a.shape[0] // k) + tuple(a.shape[1:]))
        losses = self._run("accum", ([split(a) for a in ins],
                                     [split(a) for a in outs]),
                           self._accum_body, self._row_values(self.step))
        mean_loss = losses.mean()
        self._update(mean_loss)
        return mean_loss

    def _can_scan(self) -> bool:
        return (self.scan_batches > 1 and self.conf.conf.iterations <= 1
                and algo_of(self.conf.conf) in SGD_ALGOS)

    def fit_scan(self, xs_list, ys_list):
        """K training steps (JAX graph.py :524): ``xs_list``/``ys_list``
        one [K, B, ...] stack (or list of K batches) per network input and
        output, staged on the device once, then K steps (replays on the
        card) with no host sync between them. Unmasked (fit(iterator)
        sends masked batches through fit_batch). Returns the device [K]
        losses."""
        self._check_init()
        if not self._can_scan():
            raise ValueError("fit_scan requires SGD-class training "
                             "(iterations=1, scan_batches>1)")
        if self._tp is not None:
            return self._tp.call(self, "fit_scan", xs_list, ys_list)
        dt = input_dtype(self.dtype)
        xs = [stack_on(a, self.device, dt) for a in xs_list]
        ys = [stack_on(a, self.device, dt) for a in ys_list]
        if (self.conf.backprop_type == BACKPROP_TBPTT
                and any(a.ndim == 4 and a.shape[2] > self.conf.tbptt_fwd_length
                        for a in xs)):
            raise ValueError(
                "fit_scan does not window TBPTT sequences longer than "
                f"tbptt_fwd_length={self.conf.tbptt_fwd_length}; "
                "pass single windows or use fit()")
        k = int(xs[0].shape[0])
        rows = self._graphs.rows([self._row_values(self.step + j)
                                  for j in range(k)])
        losses = torch.empty(k, dtype=torch.float32, device=self.device)
        for j in range(k):
            loss, _ = self._run("step", ([a[j] for a in xs],
                                         [a[j] for a in ys], None, None,
                                         None), self._step_body, rows[j])
            losses[j].copy_(loss)
        self.step += k
        self._score_raw = losses[-1]
        if self.listeners:
            host_losses = losses.cpu().numpy()
            for j in range(k):
                self._score_raw = float(host_losses[j])
                for listener in self.listeners:
                    listener.iteration_done(self, self.step - k + 1 + j)
        return losses

    def _fit_one_solver(self, algo, ins, labs, fmasks, lmasks):
        """Whole-graph training under a line-search solver (JAX graph.py
        :675): the loss over the flat parameter vector, its gradient from
        autograd, every evaluation drawing the same dropout masks; eager.
        The variables are read, not updated, as in JAX."""
        from ..optimize.solver import OPTIMIZERS
        cls = OPTIMIZERS.get(algo)
        if cls is None:
            raise ValueError(f"Unknown optimization_algo {algo!r}; "
                             f"available: {sorted(OPTIMIZERS)}")
        names = [(n, p) for n in sorted(self.params)
                 for p in sorted(self.params[n])]
        flat0 = torch.cat([self.params[n][p].reshape(-1) for n, p in names])

        def unravel(flat):
            out = {n: {} for n in self.params}
            off = 0
            for n, p in names:
                t = self.params[n][p]
                out[n][p] = flat[off:off + t.numel()].view(t.shape)
                off += t.numel()
            return out
        at = self._gen.get_state()

        def objective(flat):
            self._gen.set_state(at)
            params = unravel(flat)
            acts, _, preouts = self._forward_impl(
                params, ins, train=True, gen=self._gen, fmasks=fmasks,
                want_preout=True)
            return (self._loss(acts, labs, lmasks, preouts)
                    + self._reg_loss(params)).float()

        lrs = [v.layer.learning_rate for v in self.conf.vertices.values()
               if getattr(v, "layer", None) is not None]
        opt = cls(objective, max_iterations=max(1, self.conf.conf.iterations),
                  learning_rate=lrs[0] if lrs else 0.1)
        flat = opt.optimize(flat0.detach())
        copy_into(self.params, unravel(flat.to(flat0.dtype)))
        self._update(opt.score_)

    def fit(self, data, labels=None):
        """fit(inputs, labels) | fit(DataSet | MultiDataSet) |
        fit(iterator): an iterator is prefetched and its runs of
        ``scan_batches`` same-shape unmasked minibatches fused into one
        `fit_scan` (JAX graph.py :470)."""
        self._check_init()
        if labels is not None:
            self.fit_batch(data, labels)
        elif hasattr(data, "features"):
            self._fit_dataset(data)
        else:
            self._fit_iterator(data)
        return self

    def _fit_iterator(self, iterator):
        from ..datasets.iterators import prefetched
        source = prefetched(iterator, 2 * self.scan_batches,
                            pin=self.device.type == "cuda")
        if (not self._can_scan()
                or self.conf.backprop_type == BACKPROP_TBPTT):
            for ds in source:
                self._fit_dataset(ds)
            return

        def norm(ds):
            if hasattr(ds, "features_masks"):
                return (list(ds.features), list(ds.labels),
                        ds.features_masks, ds.labels_masks)
            fm = getattr(ds, "features_mask", None)
            lm = getattr(ds, "labels_mask", None)
            return ([ds.features], [ds.labels],
                    None if fm is None else [fm],
                    None if lm is None else [lm])

        buf: List[Any] = []

        def flush():
            if len(buf) < self.scan_batches:
                for ins, labs, _, _ in buf:
                    self.fit_batch(ins, labs)
            else:
                self.fit_scan([[t[0][i] for t in buf]
                               for i in range(len(buf[0][0]))],
                              [[t[1][i] for t in buf]
                               for i in range(len(buf[0][1]))])
            buf.clear()

        buf_shapes = None
        for ds in source:
            ins, labs, fms, lms = norm(ds)
            if fms is not None or lms is not None:
                flush()
                self.fit_batch(ins, labs, fms, lms)
                continue
            shapes = (tuple(tuple(a.shape) for a in ins),
                      tuple(tuple(a.shape) for a in labs))
            if buf and shapes != buf_shapes:
                flush()
            buf_shapes = shapes
            buf.append((ins, labs, fms, lms))
            if len(buf) >= self.scan_batches:
                flush()
        flush()

    def _fit_dataset(self, ds):
        if hasattr(ds, "features_masks"):  # MultiDataSet
            self.fit_batch(ds.features, ds.labels, ds.features_masks,
                           ds.labels_masks)
            return
        fm = getattr(ds, "features_mask", None)
        lm = getattr(ds, "labels_mask", None)
        self.fit_batch([ds.features], [ds.labels],
                       None if fm is None else [fm],
                       None if lm is None else [lm])

    # -- inference -------------------------------------------------------------
    @torch.inference_mode()
    def output(self, *inputs, train: bool = False,
               fmasks=None) -> List[Tensor]:
        """Full-sequence forward of host or device inputs ([B, T, F]); the
        network outputs, on the graph's device. train=True applies
        train-mode dropout."""
        self._check_init()
        acts, _ = self._forward_impl(
            self.params, self._as_tensors(list(inputs)), train=train,
            gen=self._gen if train else None,
            fmasks=self._masks_by_input(fmasks))
        return [acts[name] for name in self.conf.network_outputs]

    def output_single(self, *inputs) -> Tensor:
        """The first network output (JAX graph.py :738)."""
        return self.output(*inputs)[0]

    @torch.no_grad()
    def feed_forward(self, *inputs, train: bool = False) -> Dict[str, Tensor]:
        """Every vertex's activation and the inputs', by name (JAX
        graph.py :741); train=True draws dropout from the graph's
        generator and normalises with batch statistics (the running ones
        are not updated)."""
        self._check_init()
        acts, _ = self._forward_impl(
            self.params, self._as_tensors(list(inputs)), train=train,
            gen=self._gen if train else None)
        return acts

    @torch.inference_mode()
    def rnn_time_step(self, *inputs) -> List[Tensor]:
        """Stateful streaming inference (JAX graph.py :776): each input
        ([B, T, F], or [B, F] for one step) continues where the last call
        ended, through the recurrent vertices' h/c and the attention
        layers' contiguous KV caches, which the first call makes (capacity
        ``max_cache_len``; at the compute dtype, so a bf16 or mixed net
        keeps a bf16 cache). Returns the network outputs for these
        steps."""
        self._check_init()
        ins = [a[:, None, :] if a.ndim == 2 else a
               for a in self._as_tensors(list(inputs))]
        states = materialize_rnn_states(self._impls.items(), self._rnn_state,
                                        ins[0].shape[0], self.compute_dtype,
                                        self.device)
        acts, self._rnn_state = self._forward_impl(self.params, ins,
                                                   states=states)
        return [acts[name] for name in self.conf.network_outputs]

    def rnn_clear_previous_state(self):
        """Drop the streaming state: the next ``rnn_time_step`` starts at
        position 0 with fresh caches."""
        self._rnn_state = {}

    @torch.no_grad()
    def score(self, ds=None, inputs=None, labels=None, lmasks=None,
              fmasks=None) -> float:
        """Loss (with regularization) of a (Multi)DataSet or of inputs and
        labels, in inference mode (JAX graph.py:748)."""
        self._check_init()
        if ds is not None:
            if hasattr(ds, "features_masks"):
                inputs, labels = ds.features, ds.labels
                lmasks, fmasks = ds.labels_masks, ds.features_masks
            else:
                inputs, labels = [ds.features], [ds.labels]
                lm = getattr(ds, "labels_mask", None)
                fm = getattr(ds, "features_mask", None)
                lmasks = None if lm is None else [lm]
                fmasks = None if fm is None else [fm]
        acts, _, preouts = self._forward_impl(
            self.params, self._as_tensors(inputs),
            fmasks=self._masks_by_input(fmasks), want_preout=True)
        return float(self._loss(acts, self._as_tensors(labels),
                                self._as_tensors(lmasks), preouts)
                     + self._reg_loss(self.params))

    def evaluate(self, iterator, top_n: int = 1):
        """Classification metrics of the first output over a dataset
        iterator (JAX graph.py :847)."""
        from ..evaluation.evaluation import Evaluation
        ev = Evaluation(top_n=top_n)
        for ds in iterator:
            fm = getattr(ds, "features_mask", None)
            out = self.output(ds.features,
                              fmasks=None if fm is None else [fm])[0]
            ev.eval(ds.labels, host_array(out),
                    mask=getattr(ds, "labels_mask", None))
        return ev

    def evaluate_regression(self, iterator):
        """Per-column regression metrics of the first output (JAX graph.py
        :857)."""
        from ..evaluation.evaluation import RegressionEvaluation
        ev = RegressionEvaluation()
        for ds in iterator:
            fm = getattr(ds, "features_mask", None)
            out = self.output(ds.features,
                              fmasks=None if fm is None else [fm])[0]
            ev.eval(ds.labels, host_array(out),
                    mask=getattr(ds, "labels_mask", None))
        return ev

    # -- params ----------------------------------------------------------------
    def num_params(self) -> int:
        return int(sum(p.numel() for lp in self.params.values()
                       for p in lp.values()))

    def params_flat(self) -> np.ndarray:
        """Every parameter flattened in the JAX flat order; bf16 parameters
        come as f32 (exact), numpy having no bf16 of its own."""
        chunks = [host_array(self.params[name][pname]).reshape(-1)
                  for name in sorted(self.params)
                  for pname in sorted(self.params[name])]
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def set_params_flat(self, flat: np.ndarray):
        """Load ``flat`` (any float dtype numpy holds, bf16 included), cast
        to each parameter's dtype, into the params in place (the captured
        steps hold their addresses)."""
        flat = host_floats(flat)
        total = sum(p.numel() for lp in self.params.values()
                    for p in lp.values())
        if flat.size != total:
            raise ValueError(f"flat params hold {flat.size} values, the "
                             f"graph has {total}")
        off = 0
        for name in sorted(self.params):
            for pname in sorted(self.params[name]):
                arr = self.params[name][pname]
                n = arr.numel()
                copy_into(arr, torch.as_tensor(
                    flat[off:off + n].reshape(tuple(arr.shape))))
                off += n
        self._distributed_changed()

    def set_params(self, params: Dict[str, Dict[str, Tensor]]):
        """Load ``params`` (same names and shapes) into the params in
        place, e.g. from `util.model_serializer.params_from_jax`."""
        self._check_init()
        if set(params) != set(self.params):
            raise ValueError(f"layer names differ: {sorted(params)} vs "
                             f"{sorted(self.params)}")
        new = {}
        for name, lp in self.params.items():
            if set(params[name]) != set(lp):
                raise ValueError(f"{name}: param names differ")
            new[name] = {}
            for pname, cur in lp.items():
                t = torch.as_tensor(params[name][pname])
                if tuple(t.shape) != tuple(cur.shape):
                    raise ValueError(f"{name}.{pname}: shape "
                                     f"{tuple(t.shape)} vs {tuple(cur.shape)}")
                new[name][pname] = t
        copy_into(self.params, new)
        self._distributed_changed()

    def set_variables(self, variables: Dict[str, Dict[str, Any]]):
        """Load non-trainable variables ({vertex: {name: array}}, the
        vertices and names a subset of the graph's; e.g. from
        `util.model_serializer.variables_from_jax`), cast to each slot's
        dtype, into the variables in place."""
        self._check_init()
        for name, lv in variables.items():
            cur = self.variables.get(name)
            if cur is None or set(lv) - set(cur):
                raise ValueError(f"{name}: no such variables in the graph")
            for k, v in lv.items():
                t = torch.as_tensor(v)
                if tuple(t.shape) != tuple(cur[k].shape):
                    raise ValueError(f"{name}.{k}: shape {tuple(t.shape)} "
                                     f"vs {tuple(cur[k].shape)}")
                copy_into(cur[k], t)
        self._distributed_changed()

    def _updater_slots(self):
        """(layer, param, state name) in the JAX flat order (graph.py
        :823)."""
        us = self.updater_state
        return [(name, pname, sname) for name in sorted(us)
                for pname in sorted(us[name]) for sname in sorted(us[name][pname])]

    def updater_state_flat(self) -> np.ndarray:
        us = self.updater_state
        chunks = [us[n][p][s].detach().cpu().numpy()
                  .reshape(-1) for n, p, s in self._updater_slots()]
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def set_updater_state_flat(self, flat: np.ndarray):
        self._check_init()
        flat = np.asarray(flat)
        slots = self._updater_slots()
        us = self.updater_state
        total = sum(us[n][p][s].numel() for n, p, s in slots)
        if flat.size != total:
            raise ValueError(f"Expected {total} updater values, got "
                             f"{flat.size}")
        off = 0
        for n, p, s in slots:
            t = us[n][p][s]
            k = t.numel()
            copy_into(t, torch.as_tensor(
                flat[off:off + k].reshape(tuple(t.shape))))
            off += k
        self._distributed_changed()

    # -- misc ------------------------------------------------------------------
    def set_listeners(self, *listeners):
        self.listeners = list(listeners)

    def clone(self) -> "ComputationGraph":
        """A graph of a copy of the config on the same device, with fresh
        tensors holding this one's params, variables and updater state,
        and its step (JAX graph.py :869); it shares no captured step or
        static buffer with this one, and its generator starts from the
        seed."""
        g = ComputationGraph(copy.deepcopy(self.conf), device=self.device,
                             train_graphs=self.train_graphs)
        if self._initialized:
            g.init()
            copy_into(g.params, self.params)
            copy_into(g.variables, self.variables)
            copy_into(g.updater_state, self.updater_state)
            g.step = self.step
        return g
