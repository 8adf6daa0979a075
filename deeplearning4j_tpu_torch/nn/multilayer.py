"""MultiLayerNetwork: the sequential-network facade — port of
deeplearning4j_tpu/nn/multilayer.py (init, forward with the BN+pool pair
fusion and the recurrent layers' states, loss, regularization, the
hand-written updater step, fit_batch, fit_scan, fit_batch_accumulated,
truncated BPTT, the line-search solvers, layerwise pretraining, fit,
output, rnn_time_step, score, evaluate, the flat parameter views, clone
and summary).

Autograd replaces `jax.value_and_grad`: a train step makes each parameter
a leaf that requires grad, runs the train-mode forward, and takes the
gradients of the batch-mean loss plus the l1/l2 terms with
`torch.autograd.grad`. The update is the JAX package's `_apply_updaters`
written out (gradient normalization, lr schedule, bias lr, the updater's
rule, decoupled weight decay), not `torch.optim`, and it writes the new
params, updater state and BatchNorm variables into the net's own tensors
in place. Its step-dependent scalars (the scheduled lr, momentum, Adam's
bias corrections) are computed on the host in float32, as JAX computes
them, and read from one device row (nn/step_graph.py).

The JAX step is one compiled program; the port's is one CUDA graph
(nn/step_graph.py): with ``train_graphs="on"`` (the default) each step
on the card replays the graph captured for its key (input, label and mask
shapes, dtypes, carried states), and the key's first step runs eagerly
and captures it. ``train_graphs="off"`` runs every step eagerly, as the
CPU does; nothing falls back to it on its own. ``fit_scan`` runs K steps
on a [K, B, ...] stack staged on the device once, with no host sync
between them, and ``fit(iterator)`` prefetches on a worker thread
(`AsyncDataSetIterator`, pinned batches on the card) and fuses runs of
``scan_batches`` same-shape unmasked minibatches into one ``fit_scan``
(JAX multilayer.py :611). A truncated-BPTT net fed a time series takes
one step per window of ``tbptt_fwd_length`` (the last may be shorter, a
key of its own), the recurrent states carried from window to window in
static buffers and detached between them (JAX multilayer.py :679-706).

``optimization_algo`` other than SGD trains through the line-search
solvers of optimize/solver.py, eagerly: the objective is the loss over
the flat parameter vector and autograd its gradient. ``conf.pretrain``
runs greedy layerwise pretraining of the RBM and AutoEncoder layers
(nn/layers/pretrain.py) before ``fit(iterator)``'s supervised pass.

Remat (``conf.remat``) checkpoints each layer of the train-mode forward
but the loss path's last layer (nn/layers/base.remat_forward), and then,
as in the JAX package, leaves the BN+pool pairs unfused.

Precision (JAX multilayer.py :42-66, :165-172, :201-202, :228-229;
nn/precision.py, shared with ComputationGraph): params and the BatchNorm
variables are made at ``conf.dtype`` (float32, bfloat16 or float64); the
forward runs at ``conf.compute_dtype`` when it is set (mixed precision:
the masters cast to it in the forward, so autograd hands gradients at the
masters' dtype back to them), else at the parameter dtype. The input and
every layer's output (the fused BN+pool pair's included) are cast to the
compute dtype; the loss and the regularisation sum are f32, and so is
the updater state (nn/updater/apply.py). float64 runs on the CPU; on the
card the kernel wrappers raise for it. An unsupported ``compute_dtype``
raises ValueError.

Data parallelism (parallel/trainer.py): the ICI master drives the train
step's pieces on every rank itself — `_grads_on` with the rank's loss
scale, one gradient all-reduce, `_update_` — eagerly, outside the
captured step; parameter averaging runs the captured step locally.
ZeRO-1 (parallel/zero.py, ``_zero``): the updater state holds this
rank's slices, ``updater_state`` reads the whole, and the net trains
under the ICI master. Tensor parallelism is the ComputationGraph's
(parallel/tensor_parallel.py).

Parameters live on ``device`` (default "cuda"; it raises when no CUDA
device is present — pass device="cpu" to run on the CPU). The conv and
BN+act+pool layers run the port's CUDA kernels there (ops/helpers.py),
the f32 or the bf16 ones by the compute dtype; the recurrent layers run
plain PyTorch on either device (JAX has no kernel for them).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .conf.config import BACKPROP_TBPTT, MultiLayerConfiguration
from .conf.preprocessors import (CnnToRnnPreProcessor,
                                 FeedForwardToRnnPreProcessor)
from .layers.base import (BaseRecurrentImpl, LayerImpl, detach_states,
                          impl_for, materialize_rnn_states, remat_forward)
# importing the impl modules registers them
from .layers import attention as _attention  # noqa: F401
from .layers import convolution as _convolution
from .layers import feedforward as _feedforward  # noqa: F401
from .layers import normalization as _normalization
from .layers import pretrain as _pretrain
from .layers import recurrent as _recurrent  # noqa: F401
from .precision import (cast_floats, compute_dtype_of, dtype_of, host_array,
                        host_floats, input_dtype)
from .step_graph import (SGD_ALGOS, StepGraphs, algo_of, copy_into,
                         stack_on, to_device)
from .updater.apply import layer_scalars, update_layer_
from ..ops import losses as losses_mod
from ..util.device import DeviceLike, resolve_device

Tensor = torch.Tensor

class MultiLayerNetwork:
    _zero = None  # ZeRO-1's plan (parallel/zero.py)
    _tp = None    # tensor parallelism is the ComputationGraph's

    def __init__(self, conf: MultiLayerConfiguration, *,
                 device: DeviceLike = "cuda",
                 train_graphs: Optional[str] = None):
        self.conf = conf
        self.device = resolve_device(device)
        self.dtype = dtype_of(conf.conf)
        self.compute_dtype = compute_dtype_of(conf.conf)
        self._impls: List[LayerImpl] = [impl_for(l) for l in conf.layers]
        self._rnn_state: Dict[int, Any] = {}
        self.params: List[Dict[str, Tensor]] = []
        self.variables: List[Dict[str, Tensor]] = []
        self.updater_state: List[Dict[str, Dict[str, Tensor]]] = []
        self.step = 0
        self._score_raw: Any = float("nan")
        # minibatches fused into one fit_scan by fit(iterator)
        self.scan_batches = 16
        self.listeners: List[Any] = []
        # dropout masks: a generator on the net's device, seeded by the conf
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(conf.conf.seed))
        # "on" (default): each step on the card is a captured CUDA graph
        self._graphs = StepGraphs(
            self.device, train_graphs, row_dtype=torch.float64
            if self.dtype == torch.float64 else torch.float32)
        self._initialized = False

    @property
    def train_graphs(self) -> str:
        return self._graphs.mode

    @property
    def updater_state(self) -> List[Dict[str, Dict[str, Tensor]]]:
        """[{param: {state: tensor}}] by layer; the whole arrays under
        ZeRO-1 (gathered when read)."""
        if self._zero is not None:
            return self._zero.whole(self)
        return self._updater_state

    @updater_state.setter
    def updater_state(self, value) -> None:
        self._updater_state = value

    # ------------------------------------------------------------------ init --
    def init(self, generator: Optional[torch.Generator] = None
             ) -> "MultiLayerNetwork":
        """Draw every layer's params in layer order from ``generator``
        (default: a CPU generator seeded with the config's seed), place
        them on the net's device, and zero the variables and updater
        state."""
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(int(self.conf.conf.seed))
        self.params = [impl.init_params(gen, self.dtype, self.device)
                       for impl in self._impls]
        self.variables = [impl.init_variables(self.dtype, self.device)
                          for impl in self._impls]
        self.updater_state = [
            {name: self.conf.layers[i].updater.init_state(p)
             for name, p in lp.items()}
            for i, lp in enumerate(self.params)]
        self.step = 0
        self._graphs.drop()
        self._initialized = True
        if self._zero is not None:
            self._zero.reslice(self, fresh=True)
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

    @score_.setter
    def score_(self, v):
        self._score_raw = v

    def _as_tensor(self, a) -> Optional[Tensor]:
        return to_device(a, self.device, input_dtype(self.dtype))

    def _adapt_input(self, x: Tensor) -> Tensor:
        """Flat [B, h*w*c] rows, or [B, h, w] grayscale, fed to a net
        declared convolutional become NHWC (JAX multilayer.py :123)."""
        it = self.conf.input_type
        if it is None or getattr(it, "kind", None) != "convolutional":
            return x
        h, w, c = it.hwc()
        if x.ndim == 2 and x.shape[1] == h * w * c:
            return x.reshape(x.shape[0], h, w, c)
        if x.ndim == 3 and c == 1 and tuple(x.shape[1:]) == (h, w):
            return x[..., None]
        return x

    # ------------------------------------------------------------- forward ---
    def _forward_impl(self, params, variables, x, *, train: bool,
                      gen: Optional[torch.Generator] = None, fmask=None,
                      states: Optional[Dict[int, Any]] = None,
                      upto: Optional[int] = None, fuse_pairs: bool = False,
                      want_preout: bool = False):
        """Forward through layers [0, upto). Returns (activations per
        layer, new variables, the stateful layers' new states by layer
        index, the last layer's PRE-activation when ``want_preout`` else
        None). A stateful layer starts from ``states[i]`` where given,
        else from zeros (the attention layer then runs its stateless
        full-sequence path).

        ``fuse_pairs`` (set only by the train step, whose activations feed
        nothing but the loss) runs each [BatchNormalization -> 2x2/s2 max
        pool] pair as the one composite op of ops/helpers.bn_act_pool, as
        the JAX package does (multilayer.py :186-210), unless remat
        checkpoints the layers."""
        conf = self.conf
        n = len(self._impls) if upto is None else upto
        dtype = self.compute_dtype
        if dtype != self.dtype:  # mixed precision: compute on cast masters
            params = cast_floats(params, dtype)
        cur = self._adapt_input(x)
        if cur.is_floating_point() and cur.dtype != dtype:
            cur = cur.to(dtype)
        timesteps = cur.shape[1] if cur.ndim == 3 else 1
        acts: List[Tensor] = []
        new_vars = list(variables)
        new_states: Dict[int, Any] = {}
        preout = None
        ckpt = train and bool(conf.conf.remat)
        i = 0
        while i < n:
            proc = conf.preprocessor(i)
            if proc is not None:
                if isinstance(proc, (FeedForwardToRnnPreProcessor,
                                     CnnToRnnPreProcessor)):
                    cur = proc.preprocess_with_time(cur, timesteps)
                else:
                    cur = (proc.preprocess_train(cur, gen) if train
                           else proc.preprocess(cur))
            if cur.ndim == 3:
                timesteps = cur.shape[1]
            impl = self._impls[i]
            mask = fmask if cur.ndim == 3 else None
            if (train and fuse_pairs and not ckpt and i + 1 < n
                    and isinstance(impl, _normalization.BatchNormalizationImpl)
                    and isinstance(self._impls[i + 1],
                                   _convolution.SubsamplingLayerImpl)
                    and conf.preprocessor(i + 1) is None
                    and impl.can_fuse_pool(impl.conf,
                                           self._impls[i + 1].conf, cur)):
                y, new_vars[i] = impl.forward_fused_pool(
                    params[i], cur, variables=variables[i])
                if y.is_floating_point() and y.dtype != dtype:
                    y = y.to(dtype)
                acts += [y, y]  # both fused layers record the pooled output
                cur = y
                i += 2
                continue
            if isinstance(impl, BaseRecurrentImpl):
                y, new_states[i] = remat_forward(
                    impl, train=train, ckpt=ckpt, recurrent=True)(
                    params[i], cur, (states or {}).get(i), gen, mask)
            elif (want_preout and i == n - 1
                    and hasattr(impl, "forward_with_preout")):
                y, preout = impl.forward_with_preout(
                    params[i], cur, train=train, gen=gen, mask=mask)
            else:
                y, new_vars[i] = remat_forward(
                    impl, train=train, ckpt=ckpt, recurrent=False)(
                    params[i], cur, variables[i], gen, mask)
            if y.is_floating_point() and y.dtype != dtype:
                y = y.to(dtype)  # stop f32 creep under mixed precision
            acts.append(y)
            cur = y
            i += 1
        return acts, new_vars, new_states, preout

    def _loss_from_output(self, out: Tensor, y: Tensor,
                          lmask: Optional[Tensor],
                          preout: Optional[Tensor] = None) -> Tensor:
        out_conf = self.conf.layers[-1]
        loss_name = getattr(out_conf, "loss", None) or "mse"
        fused = losses_mod.fused_from_logits(
            getattr(out_conf, "activation", None), loss_name)
        if preout is not None and fused is not None:
            out, loss_fn = preout, fused  # the stable from-logits path
        else:
            loss_fn = losses_mod.get(loss_name)
        m = lmask.reshape(-1) if lmask is not None else None
        if out.ndim == 3:  # per-timestep output: flatten time
            return loss_fn(y.reshape(-1, y.shape[-1]),
                           out.reshape(-1, out.shape[-1]), m)
        return loss_fn(y, out, m)

    def _reg_loss(self, params) -> Tensor:
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for impl, p in zip(self._impls, params):
            if p:
                total = total + impl.reg_loss(p)
        return total

    # ---------------------------------------------------------- train step ---
    def compute_gradient_and_score(self, x, y, fmask=None, lmask=None):
        """One train-mode forward and backward on a minibatch, without
        updating anything: (loss, per-layer gradient dicts, the new
        variables). The loss is the batch mean plus regularization (JAX
        `_build_loss_fn`, multilayer.py :298), with the BN+pool pairs
        fused."""
        self._check_init()
        return self._grads_on(*map(self._as_tensor, (x, y, fmask, lmask)),
                              None, self.variables)[:3]

    def _grads_on(self, x, y, fmask, lmask, states, variables,
                  loss_scales=None, with_reg: bool = True):
        """(loss, gradients, new variables, new recurrent states): the
        train step's forward from ``states`` (None: zeros) and
        ``variables``, and its backward, on device tensors. A data-parallel
        rank (parallel/trainer.py) scales the loss by its share of the
        global weight (``loss_scales``, one float) and adds the
        regularization on one rank only (``with_reg``)."""
        params = [{k: v.detach().requires_grad_(True) for k, v in lp.items()}
                  for lp in self.params]
        acts, new_vars, new_states, preout = self._forward_impl(
            params, variables, x, train=True, gen=self._gen,
            fmask=fmask, states=states, fuse_pairs=True, want_preout=True)
        loss = self._loss_from_output(acts[-1], y, lmask, preout=preout)
        if loss_scales is not None:
            loss = loss * loss_scales[0]
        if with_reg:
            loss = loss + self._reg_loss(params)
        loss = loss.float()
        leaves = [p for lp in params for p in lp.values()]
        flat = torch.autograd.grad(loss, leaves, allow_unused=True) \
            if leaves else ()
        flat_iter = iter(flat)
        grads = []
        for lp in params:
            g = {}
            for k, p in lp.items():
                gk = next(flat_iter)
                g[k] = torch.zeros_like(p) if gk is None else gk
            grads.append(g)
        return loss.detach(), grads, new_vars, new_states

    def _row_values(self, step: int) -> List[float]:
        """The scalars of step ``step`` for every layer with params, in
        the order the step body reads them (nn/updater/apply.py)."""
        vals: List[float] = []
        for i, lc in enumerate(self.conf.layers):
            if self.params[i]:
                vals += layer_scalars(lc, self.conf.conf,
                                      self._impls[i].WEIGHT_KEYS,
                                      self.params[i], step)
        return vals

    def _state_tensors(self) -> List[Tensor]:
        """The tensors a step writes in place."""
        return ([t for lp in self.params for t in lp.values()]
                + [t for lv in self.variables for t in lv.values()]
                + [t for lu in self.updater_state for st in lu.values()
                   for t in st.values()])

    @torch.no_grad()
    def _update_(self, grads, zero=None) -> None:
        """Every layer's update, in place, its scalars from the row.
        ``zero``: ZeRO-1's (plan, data communicator), which updates this
        rank's slices (nn/updater/apply.py)."""
        row = iter(self._graphs.row_views)
        for i, lc in enumerate(self.conf.layers):
            if grads[i]:
                update_layer_(lc, self._impls[i].WEIGHT_KEYS, self.params[i],
                              grads[i], self._updater_state[i], row,
                              zero=None if zero is None
                              else (zero[0].dims[i], zero[1]))

    @torch.no_grad()
    def _assign_variables(self, new_vars) -> None:
        for lv, nv in zip(self.variables, new_vars):
            if nv is not lv:
                for k, t in nv.items():
                    lv[k].copy_(t)

    def _step_body(self, x, y, fmask, lmask, states):
        """One optimization step on device tensors — what a capture
        records: (loss, the recurrent layers' new states)."""
        loss, grads, new_vars, new_states = self._grads_on(
            x, y, fmask, lmask, states, self.variables)
        self._update_(grads)
        self._assign_variables(new_vars)
        return loss, detach_states(new_states)

    def _accum_body(self, xs, ys, fms, lms):
        """One update from the mean of K microbatch gradients (JAX
        `_build_accum_step`, multilayer.py :337): BatchNorm statistics
        per microbatch, carried from one to the next. The K losses."""
        k = xs.shape[0]
        variables, gsum, losses = self.variables, None, []
        for i in range(k):
            loss, grads, variables, _ = self._grads_on(
                xs[i], ys[i], None if fms is None else fms[i],
                None if lms is None else lms[i], None, variables)
            losses.append(loss)
            gsum = grads if gsum is None else [
                {n: gs[n] + g for n, g in lg.items()}
                for gs, lg in zip(gsum, grads)]
        self._update_([{n: g / k for n, g in lg.items()} for lg in gsum])
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

    def _iteration_done(self):
        self.step += 1
        for listener in self.listeners:
            listener.iteration_done(self, self.step)

    def fit_batch(self, x, y, fmask=None, lmask=None, states=None,
                  carry_state: bool = False):
        """``conf.iterations`` optimization steps (at least one) on one
        minibatch; the score stays on the device until read. With
        ``carry_state`` each iteration starts the recurrent layers from
        ``states`` (one truncated-BPTT window; JAX multilayer.py :516).
        Returns the last iteration's new recurrent states. A solver
        ``optimization_algo`` trains through optimize/solver.py."""
        self._check_init()
        x, y = self._as_tensor(x), self._as_tensor(y)
        fmask, lmask = self._as_tensor(fmask), self._as_tensor(lmask)
        algo = algo_of(self.conf.conf)
        if algo not in SGD_ALGOS:
            if carry_state:
                raise NotImplementedError(
                    f"optimization_algo={algo!r} is not supported with "
                    "truncated BPTT; use stochastic_gradient_descent")
            return self._fit_batch_solver(algo, x, y, fmask, lmask)
        out_states = states
        for _ in range(max(1, self.conf.conf.iterations)):
            loss, out_states = self._run(
                "step", (x, y, fmask, lmask, states if carry_state else None),
                self._step_body, self._row_values(self.step))
            self._score_raw = loss
            self._iteration_done()
        return out_states

    def fit_batch_accumulated(self, x, y, accumulation_steps: int,
                              fmask=None, lmask=None):
        """ONE optimizer step on a batch split into ``accumulation_steps``
        microbatches (the batch must divide evenly): the mean of their
        gradients, one update, as one captured graph on the card (JAX
        multilayer.py :376). Equal to ``fit_batch`` on the whole batch for
        BatchNorm-free, unmasked nets; BatchNorm takes per-microbatch
        statistics. Returns the mean microbatch loss, on the device."""
        self._check_init()
        algo = algo_of(self.conf.conf)
        if algo not in SGD_ALGOS or self.conf.conf.iterations > 1:
            raise ValueError(
                "fit_batch_accumulated supports SGD-family training with "
                f"iterations=1 (got algo={algo!r}, "
                f"iterations={self.conf.conf.iterations}); use fit_batch "
                "for solver-based optimization")
        k = int(accumulation_steps)
        if k <= 0:
            raise ValueError(f"accumulation_steps must be >= 1 (got {k})")
        x = self._as_tensor(x)
        if x.shape[0] % k:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"accumulation_steps {k}")

        def split(a):
            a = self._as_tensor(a)
            return None if a is None else a.reshape(
                (k, a.shape[0] // k) + tuple(a.shape[1:]))
        losses = self._run("accum", (split(x), split(y), split(fmask),
                                     split(lmask)),
                           self._accum_body, self._row_values(self.step))
        mean_loss = losses.mean()
        self._score_raw = mean_loss
        self._iteration_done()
        return mean_loss

    def _can_scan(self) -> bool:
        return (self.scan_batches > 1
                and self.conf.conf.iterations <= 1
                and algo_of(self.conf.conf) in SGD_ALGOS)

    def fit_scan(self, xs, ys, fms=None, lms=None):
        """K optimization steps, one per ``xs[k]`` (JAX multilayer.py
        :459): xs, ys (and the masks) [K, B, ...] stacks, or lists of K
        batches, staged on the device once; then K steps (replays on the
        card) with no host sync between them, step k's loss written to
        row k of the returned device [K] tensor. No TBPTT windowing: a
        TBPTT net takes single windows. Listeners get each step's score,
        and see the parameters of the chunk's end."""
        self._check_init()
        if not self._can_scan():
            raise ValueError(
                "fit_scan requires SGD-class training (optimization_algo="
                "stochastic_gradient_descent, iterations=1, scan_batches>1); "
                "use fit()/fit_batch for solver-driven or multi-iteration "
                "configurations")
        dt = input_dtype(self.dtype)
        xs, ys = stack_on(xs, self.device, dt), stack_on(ys, self.device, dt)
        fms, lms = stack_on(fms, self.device, dt), stack_on(lms, self.device,
                                                           dt)
        if (self.conf.backprop_type == BACKPROP_TBPTT and xs.ndim == 4
                and xs.shape[2] > self.conf.tbptt_fwd_length):
            raise ValueError(
                f"fit_scan slices have T={xs.shape[2]} > tbptt_fwd_length="
                f"{self.conf.tbptt_fwd_length}; fit_scan does not window — "
                "pass single TBPTT windows or use fit()")
        k = int(xs.shape[0])
        rows = self._graphs.rows([self._row_values(self.step + j)
                                  for j in range(k)])
        losses = torch.empty(k, dtype=torch.float32, device=self.device)
        for j in range(k):
            loss, _ = self._run(
                "step", (xs[j], ys[j], None if fms is None else fms[j],
                         None if lms is None else lms[j], None),
                self._step_body, rows[j])
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

    def _flat_params(self):
        """(the params as one flat vector in the `params_flat` order, a
        function from such a vector to per-layer dicts of its views)."""
        names = [(i, k) for i, lp in enumerate(self.params)
                 for k in sorted(lp)]
        flat0 = torch.cat([self.params[i][k].reshape(-1) for i, k in names]) \
            if names else torch.zeros(0, device=self.device)

        def unravel(flat):
            out = [dict() for _ in self.params]
            off = 0
            for i, k in names:
                t = self.params[i][k]
                out[i][k] = flat[off:off + t.numel()].view(t.shape)
                off += t.numel()
            return out
        return flat0, unravel

    def _fit_batch_solver(self, algo: str, x, y, fmask, lmask):
        """Whole-net training under a line-search solver (JAX
        multilayer.py :546): the objective is the minibatch loss plus
        regularization over the flat parameter vector, its gradient from
        autograd, every evaluation drawing the same dropout masks; it
        runs eagerly, the search branching on the host. ``iterations``
        bounds the solver's iterations. The BatchNorm variables are
        refreshed by one train-mode forward at the end."""
        from ..optimize.solver import OPTIMIZERS
        cls = OPTIMIZERS.get(algo)
        if cls is None:
            raise ValueError(
                f"Unknown optimization_algo {algo!r}; available: "
                f"{sorted(OPTIMIZERS)}")
        flat0, unravel = self._flat_params()
        at = self._gen.get_state()

        def objective(flat):
            self._gen.set_state(at)
            params = unravel(flat)
            acts, _, _, preout = self._forward_impl(
                params, self.variables, x, train=True, gen=self._gen,
                fmask=fmask, want_preout=True)
            loss = self._loss_from_output(acts[-1], y, lmask, preout=preout)
            return (loss + self._reg_loss(params)).float()

        lr = self.conf.layers[0].learning_rate if self.conf.layers else 0.1
        opt = cls(objective, max_iterations=max(1, self.conf.conf.iterations),
                  learning_rate=lr)
        flat = opt.optimize(flat0.detach())
        with torch.no_grad():
            for lp, nd in zip(self.params, unravel(flat.to(flat0.dtype))):
                for k, t in nd.items():
                    lp[k].copy_(t)
            self._gen.set_state(at)
            new_vars = self._forward_impl(self.params, self.variables, x,
                                          train=True, gen=self._gen,
                                          fmask=fmask)[1]
            self._assign_variables(new_vars)
        self._score_raw = opt.score_
        self._iteration_done()
        return None

    def _fit_one(self, x, y, fmask, lmask):
        x = self._as_tensor(x)
        if self.conf.backprop_type == BACKPROP_TBPTT and x.ndim == 3:
            self._do_truncated_bptt(x, y, fmask, lmask)
        else:
            self.fit_batch(x, y, fmask, lmask)

    def _do_truncated_bptt(self, x, y, fmask, lmask):
        """One fit_batch per window of ``tbptt_fwd_length`` steps (JAX
        multilayer.py :686; ``tbptt_back_length`` is not read, as in JAX),
        the last window shorter where T is not a multiple. 2-d labels go
        whole to every window. The recurrent states start at zeros, carry
        from window to window and are detached between windows; the
        attention layers run each window stateless."""
        x, y = self._as_tensor(x), self._as_tensor(y)
        fmask, lmask = self._as_tensor(fmask), self._as_tensor(lmask)
        T = x.shape[1]
        L = self.conf.tbptt_fwd_length
        states = materialize_rnn_states(
            enumerate(self._impls), {}, x.shape[0], self.compute_dtype,
            self.device, tbptt=True)
        for start in range(0, T, L):
            end = min(start + L, T)
            states = self.fit_batch(
                x[:, start:end], y[:, start:end] if y.ndim == 3 else y,
                None if fmask is None else fmask[:, start:end],
                None if lmask is None else lmask[:, start:end],
                states=states, carry_state=True)
            states = detach_states(states)

    # ------------------------------------------------------------------ fit --
    def fit(self, data, labels=None):
        """fit(DataSetIterator) | fit(DataSet) | fit(x, y); an iterator
        first pretrains layerwise where ``conf.pretrain`` is set."""
        self._check_init()
        if labels is not None:
            self._fit_one(data, labels, None, None)
            return self
        if hasattr(data, "features"):  # one DataSet
            self._fit_one(data.features, data.labels,
                          getattr(data, "features_mask", None),
                          getattr(data, "labels_mask", None))
            return self
        if self.conf.pretrain:
            self.pretrain(data)
            if hasattr(data, "reset"):
                data.reset()
        if self.conf.backprop:
            self._fit_iterator(data)
        return self

    def _fit_iterator(self, iterator):
        """fit over an iterator (JAX multilayer.py :611): a background
        prefetch (pinned batches on the card), and runs of
        ``scan_batches`` same-shape unmasked minibatches fused into one
        `fit_scan`; a shorter run takes single steps, a masked batch or a
        truncated-BPTT net one `_fit_one` each."""
        from ..datasets.iterators import prefetched
        source = prefetched(iterator, 2 * self.scan_batches,
                            pin=self.device.type == "cuda")
        if not (self._can_scan()
                and self.conf.backprop_type != BACKPROP_TBPTT):
            for ds in source:
                self._fit_one(ds.features, ds.labels,
                              getattr(ds, "features_mask", None),
                              getattr(ds, "labels_mask", None))
            return
        buf: List[Any] = []

        def flush():
            if len(buf) < self.scan_batches:
                for d in buf:
                    self.fit_batch(d.features, d.labels)
            else:
                self.fit_scan([d.features for d in buf],
                              [d.labels for d in buf])
            buf.clear()

        buf_shapes = None
        for ds in source:
            fm = getattr(ds, "features_mask", None)
            lm = getattr(ds, "labels_mask", None)
            if fm is not None or lm is not None:
                flush()
                self._fit_one(ds.features, ds.labels, fm, lm)
                continue
            shapes = (tuple(ds.features.shape), tuple(ds.labels.shape))
            if buf and shapes != buf_shapes:
                flush()
            buf_shapes = shapes
            buf.append(ds)
            if len(buf) >= self.scan_batches:
                flush()
        flush()

    # ------------------------------------------------------------- pretrain --
    def pretrain(self, iterator):
        """Greedy layerwise pretraining (JAX multilayer.py :708): each RBM
        or AutoEncoder layer in turn takes one step per minibatch of the
        iterator, on the inference-mode output of the layers below it;
        the score is each step's CD reconstruction error or loss. The
        steps run eagerly and leave ``step`` where it was, as in JAX."""
        self._check_init()
        for i in range(len(self._impls)):
            if not self.conf.layers[i].is_pretrain_layer():
                continue
            step_fn = self._make_pretrain_step(i)
            if hasattr(iterator, "reset"):
                iterator.reset()
            for ds in iterator:
                x = self._as_tensor(ds.features)
                if i > 0:
                    with torch.no_grad():
                        x = self._forward_impl(self.params, self.variables,
                                               x, train=False, upto=i)[0][-1]
                self._score_raw = float(step_fn(x))

    def _make_pretrain_step(self, i: int, draws=None):
        """Layer ``i``'s pretraining step x -> loss (JAX multilayer.py
        :730): the CD-k gradient of an RBM or autograd of an
        AutoEncoder's denoising loss, then the layer's update with the
        base lr for every param and the decoupled weight decay. ``draws``
        (default: the net's generator) supplies the uniforms."""
        impl = self._impls[i]
        lc = self.conf.layers[i]
        gconf = self.conf.conf
        draws = draws or _pretrain.GeneratorDraws(self._gen)

        def apply(grads):
            row = layer_scalars(lc, gconf, impl.WEIGHT_KEYS, self.params[i],
                                self.step, bias_lr=False)
            update_layer_(lc, impl.WEIGHT_KEYS, self.params[i], grads,
                          self.updater_state[i], iter(row))

        if isinstance(impl, _pretrain.RBMImpl):
            def rbm_step(x):
                with torch.no_grad():
                    grads, recon = impl.cd_gradient(self.params[i], x, draws)
                apply(grads)
                return recon
            return rbm_step
        if isinstance(impl, _pretrain.AutoEncoderImpl):
            def ae_step(x):
                params = {k: v.detach().requires_grad_(True)
                          for k, v in self.params[i].items()}
                loss = impl.pretrain_loss(params, x, draws)
                names = list(params)
                gs = torch.autograd.grad(loss, [params[k] for k in names])
                apply(dict(zip(names, gs)))
                return loss.detach()
            return ae_step
        raise ValueError(f"Layer {i} is not a pretrainable layer")

    def finetune(self, iterator):
        """The supervised pass after pretraining (JAX multilayer.py
        :778): one step per minibatch, masks unread."""
        for ds in iterator:
            self._fit_one(ds.features, ds.labels, None, None)

    # ---------------------------------------------------------- inference ----
    @torch.no_grad()
    def output(self, x, train: bool = False, fmask=None) -> Tensor:
        """The network output on the net's device. train=True applies
        train-mode dropout and batch statistics (the running statistics
        are not updated)."""
        self._check_init()
        acts = self._forward_impl(
            self.params, self.variables, self._as_tensor(x), train=train,
            gen=self._gen if train else None,
            fmask=self._as_tensor(fmask))[0]
        return acts[-1]

    def predict(self, x) -> np.ndarray:
        return self.output(x).argmax(dim=-1).cpu().numpy()

    @torch.no_grad()
    def feed_forward(self, x, train: bool = False) -> List[Tensor]:
        """All layer activations, the input first."""
        self._check_init()
        x = self._as_tensor(x)
        acts = self._forward_impl(self.params, self.variables, x,
                                  train=train,
                                  gen=self._gen if train else None)[0]
        return [x] + acts

    @torch.no_grad()
    def score(self, dataset=None, x=None, y=None) -> float:
        """Loss (with regularization) on a dataset, or the last
        minibatch's score."""
        if dataset is None and x is None:
            return self.score_
        self._check_init()
        if dataset is not None:
            x, y = dataset.features, dataset.labels
            lmask = getattr(dataset, "labels_mask", None)
            fmask = getattr(dataset, "features_mask", None)
        else:
            lmask = fmask = None
        acts, _, _, preout = self._forward_impl(
            self.params, self.variables, self._as_tensor(x), train=False,
            fmask=self._as_tensor(fmask), want_preout=True)
        loss = self._loss_from_output(acts[-1], self._as_tensor(y),
                                      self._as_tensor(lmask), preout=preout)
        return float(loss + self._reg_loss(self.params))

    def evaluate(self, iterator, top_n: int = 1):
        """Classification metrics over a dataset iterator (JAX
        multilayer.py :939): accuracy, top-n, precision, recall, f1 and
        the confusion matrix, from the outputs read back per minibatch."""
        from ..evaluation.evaluation import Evaluation
        ev = Evaluation(top_n=top_n)
        for ds in iterator:
            out = self.output(ds.features,
                              fmask=getattr(ds, "features_mask", None))
            ev.eval(ds.labels, host_array(out),
                    mask=getattr(ds, "labels_mask", None))
        return ev

    def evaluate_regression(self, iterator):
        """Per-column regression metrics over a dataset iterator (JAX
        multilayer.py :948)."""
        from ..evaluation.evaluation import RegressionEvaluation
        ev = RegressionEvaluation()
        for ds in iterator:
            out = self.output(ds.features,
                              fmask=getattr(ds, "features_mask", None))
            ev.eval(ds.labels, host_array(out),
                    mask=getattr(ds, "labels_mask", None))
        return ev

    # -------------------------------------------------------- rnn stepping ---
    @torch.no_grad()
    def rnn_time_step(self, x) -> Tensor:
        """Stateful streaming inference (JAX multilayer.py :837): x [B, T,
        F] (or [B, F], one step) continues where the last call ended; the
        recurrent layers' h/c and the attention layers' KV caches are kept
        between calls until ``rnn_clear_previous_state``. Returns the
        output for these steps, on the net's device."""
        self._check_init()
        x = self._as_tensor(x)
        if x.ndim == 2:
            x = x[:, None, :]
        states = materialize_rnn_states(
            enumerate(self._impls), self._rnn_state, x.shape[0],
            self.compute_dtype, self.device)
        acts, _, self._rnn_state, _ = self._forward_impl(
            self.params, self.variables, x, train=False, states=states)
        return acts[-1]

    def rnn_clear_previous_state(self):
        self._rnn_state = {}

    def rnn_get_previous_state(self, layer_idx: int):
        return self._rnn_state.get(layer_idx)

    def rnn_set_previous_state(self, layer_idx: int, state):
        self._rnn_state[layer_idx] = state

    # ------------------------------------------------------------ params -----
    def num_params(self) -> int:
        return int(sum(p.numel() for lp in self.params for p in lp.values()))

    def params_flat(self) -> np.ndarray:
        """Flat parameter view in (layer, sorted name) order — the order of
        the model zip's ``coefficients.bin``, shared with the JAX package;
        bf16 parameters come as f32 (exact)."""
        chunks = [host_array(lp[name]).reshape(-1)
                  for lp in self.params for name in sorted(lp)]
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def _unflatten(self, flat, like):
        flat = host_floats(flat)
        off = 0
        out = []
        for d in like:
            nd = {}
            for name in sorted(d):
                t = d[name]
                n = t.numel()
                nd[name] = torch.as_tensor(
                    flat[off:off + n].reshape(tuple(t.shape))).to(
                    device=t.device, dtype=t.dtype)
                off += n
            out.append(nd)
        if off != flat.size:
            raise ValueError(f"Expected {off} values, got {flat.size}")
        return out

    def set_params_flat(self, flat: np.ndarray):
        """Load ``flat`` (any float dtype numpy holds, a JAX bf16 net's
        included), cast to each parameter's dtype, into the params in
        place (the captured steps hold their addresses)."""
        self._check_init()
        copy_into(self.params, self._unflatten(flat, self.params))

    def set_params(self, params: List[Dict[str, Tensor]]):
        """Load ``params`` (one dict per layer, same names and shapes)
        into the params in place, e.g. from
        `util.model_serializer.params_from_jax`."""
        self._check_init()
        if len(params) != len(self.params):
            raise ValueError(f"{len(params)} layers given, the net has "
                             f"{len(self.params)}")
        new = []
        for i, (given, cur) in enumerate(zip(params, self.params)):
            if set(given) != set(cur):
                raise ValueError(f"layer {i}: param names differ")
            nd = {}
            for name, t in cur.items():
                v = torch.as_tensor(given[name])
                if tuple(v.shape) != tuple(t.shape):
                    raise ValueError(f"layer {i}.{name}: shape "
                                     f"{tuple(v.shape)} vs {tuple(t.shape)}")
                nd[name] = v
            new.append(nd)
        copy_into(self.params, new)

    def updater_state_flat(self) -> np.ndarray:
        us = self.updater_state
        chunks = [lu[name][s].detach().cpu().numpy().reshape(-1)
                  for lu in us for name in sorted(lu)
                  for s in sorted(lu[name])]
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def set_updater_state_flat(self, flat: np.ndarray):
        """Load ``flat`` into the updater state in place."""
        self._check_init()
        flat = np.asarray(flat)
        off = 0
        new = []
        us = self.updater_state
        for lu in us:
            nlu = {}
            for name in sorted(lu):
                nlu[name] = {}
                for s in sorted(lu[name]):
                    n = lu[name][s].numel()
                    nlu[name][s] = torch.as_tensor(
                        flat[off:off + n].reshape(tuple(lu[name][s].shape)))
                    off += n
            new.append(nlu)
        if off != flat.size:
            raise ValueError(f"Expected {off} updater values, got {flat.size}")
        copy_into(us, new)
        if self._zero is not None:
            self._zero.reslice(self)

    # ------------------------------------------------------------- misc ------
    def set_listeners(self, *listeners):
        self.listeners = list(listeners)

    def add_listener(self, listener):
        self.listeners.append(listener)

    def clone(self) -> "MultiLayerNetwork":
        """A net of a copy of the config on the same device, with fresh
        tensors holding this one's params, variables and updater state,
        and its step (JAX multilayer.py :927); it shares no captured step
        or static buffer with this one, and its generator starts from the
        seed."""
        net = MultiLayerNetwork(copy.deepcopy(self.conf), device=self.device,
                                train_graphs=self.train_graphs)
        if self._initialized:
            net.init()
            copy_into(net.params, self.params)
            copy_into(net.variables, self.variables)
            copy_into(net.updater_state, self.updater_state)
            net.step = self.step
        return net

    def summary(self) -> str:
        """One line per layer with its parameter count, and the total
        (JAX multilayer.py :959)."""
        lines = ["=" * 70]
        for i, lc in enumerate(self.conf.layers):
            nparams = sum(p.numel() for p in self.params[i].values()) \
                if self._initialized else 0
            lines.append(f"{i:3d}  {type(lc).__name__:30s} params={nparams}")
        lines.append("Total params: "
                     f"{self.num_params() if self._initialized else '?'}")
        lines.append("=" * 70)
        return "\n".join(lines)
