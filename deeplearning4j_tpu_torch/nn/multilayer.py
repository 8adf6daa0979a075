"""MultiLayerNetwork: the sequential-network facade — port of
deeplearning4j_tpu/nn/multilayer.py (init, forward with the BN+pool pair
fusion and the recurrent layers' states, loss, regularization, the
hand-written updater step, fit_batch, truncated BPTT, fit, output,
rnn_time_step, score, evaluate and the flat parameter views).

Autograd replaces `jax.value_and_grad`: a train step makes each parameter
a leaf that requires grad, runs the train-mode forward, and takes the
gradients of the batch-mean loss plus the l1/l2 terms with
`torch.autograd.grad`. The update is the JAX package's `_apply_updaters`
written out (gradient normalization, lr schedule, bias lr, the updater's
rule, decoupled weight decay), not `torch.optim`. PyTorch runs eagerly,
so there is no jit cache and no `fit_scan`: `fit` runs one `fit_batch`
per minibatch, or, for a truncated-BPTT net fed a time series, one per
window of ``tbptt_fwd_length`` steps (the last may be shorter), the
recurrent states carried from window to window and detached between them
(JAX multilayer.py :679-706).

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

Parameters live on ``device`` (default "cuda"; it raises when no CUDA
device is present — pass device="cpu" to run on the CPU). The conv and
BN+act+pool layers run the port's CUDA kernels there (ops/helpers.py),
the f32 or the bf16 ones by the compute dtype; the recurrent layers run
plain PyTorch on either device (JAX has no kernel for them).
Not ported yet, and raising where a config asks for them: solvers other
than SGD and layerwise pretraining (ROADMAP A5).
"""
from __future__ import annotations

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
from .layers import recurrent as _recurrent  # noqa: F401
from .precision import (cast_floats, compute_dtype_of, dtype_of, host_array,
                        host_floats, input_dtype)
from .updater.apply import update_layer
from ..ops import losses as losses_mod
from ..util.device import DeviceLike, resolve_device

Tensor = torch.Tensor

_SGD_ALGOS = ("stochastic_gradient_descent", "sgd")


def _check_supported(conf: MultiLayerConfiguration) -> None:
    g = conf.conf
    if conf.pretrain:
        raise NotImplementedError("layerwise pretraining is queued as "
                                  "ROADMAP A5")
    if (g.optimization_algo or "stochastic_gradient_descent").lower() \
            not in _SGD_ALGOS:
        raise NotImplementedError(
            f"optimization_algo={g.optimization_algo!r}: the port trains "
            "with SGD-family updaters; the line-search solvers are queued "
            "as ROADMAP A5")


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, *,
                 device: DeviceLike = "cuda"):
        _check_supported(conf)
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
        self.listeners: List[Any] = []
        # dropout masks: a generator on the net's device, seeded by the conf
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(conf.conf.seed))
        self._initialized = False

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
        self._initialized = True
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
        if a is None:
            return None
        t = a if isinstance(a, Tensor) else torch.as_tensor(np.asarray(a))
        t = t.to(self.device)
        return t.to(input_dtype(self.dtype)) if t.is_floating_point() else t

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
                    cur = proc.preprocess(cur)
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
        return self._train_grads(x, y, fmask, lmask)[:3]

    def _train_grads(self, x, y, fmask, lmask, states=None):
        """(loss, gradients, new variables, new recurrent states): the
        train step's forward from ``states`` (None: zeros) and backward."""
        self._check_init()
        x, y = self._as_tensor(x), self._as_tensor(y)
        fmask, lmask = self._as_tensor(fmask), self._as_tensor(lmask)
        params = [{k: v.detach().requires_grad_(True) for k, v in lp.items()}
                  for lp in self.params]
        acts, new_vars, new_states, preout = self._forward_impl(
            params, self.variables, x, train=True, gen=self._gen,
            fmask=fmask, states=states, fuse_pairs=True, want_preout=True)
        loss = (self._loss_from_output(acts[-1], y, lmask, preout=preout)
                + self._reg_loss(params)).float()
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

    def _apply_updaters(self, params, grads, ustates, step: int):
        """(new params, new updater states) — JAX multilayer.py :262."""
        new_params, new_ustates = [], []
        for i, layer_conf in enumerate(self.conf.layers):
            if not grads[i]:
                new_params.append(params[i])
                new_ustates.append(ustates[i])
                continue
            lp, lu = update_layer(layer_conf, self.conf.conf,
                                  self._impls[i].WEIGHT_KEYS, params[i],
                                  grads[i], ustates[i], step)
            new_params.append(lp)
            new_ustates.append(lu)
        return new_params, new_ustates

    def fit_batch(self, x, y, fmask=None, lmask=None, states=None,
                  carry_state: bool = False):
        """``conf.iterations`` optimization steps (at least one) on one
        minibatch; the score stays on the device until read. With
        ``carry_state`` each iteration starts the recurrent layers from
        ``states`` (one truncated-BPTT window; JAX multilayer.py :516).
        Returns the last iteration's new recurrent states."""
        self._check_init()
        x, y = self._as_tensor(x), self._as_tensor(y)
        out_states = states
        for _ in range(max(1, self.conf.conf.iterations)):
            loss, grads, new_vars, out_states = self._train_grads(
                x, y, fmask, lmask, states if carry_state else None)
            self.params, self.updater_state = self._apply_updaters(
                self.params, grads, self.updater_state, self.step)
            self.variables = new_vars
            self._score_raw = loss
            self.step += 1
            for listener in self.listeners:
                listener.iteration_done(self, self.step)
        return out_states

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
        """fit(DataSetIterator) | fit(DataSet) | fit(x, y)."""
        self._check_init()
        if labels is not None:
            self._fit_one(data, labels, None, None)
            return self
        if hasattr(data, "features"):  # one DataSet
            self._fit_one(data.features, data.labels,
                          getattr(data, "features_mask", None),
                          getattr(data, "labels_mask", None))
            return self
        if self.conf.backprop:
            self._fit_iterator(data)
        return self

    def _fit_iterator(self, iterator):
        """One fit_batch (or one truncated-BPTT pass) per minibatch of the
        iterator (iterating resets it first). The JAX package's background
        prefetch and its lax.scan chunks have no counterpart here yet."""
        for ds in iterator:
            self._fit_one(ds.features, ds.labels,
                          getattr(ds, "features_mask", None),
                          getattr(ds, "labels_mask", None))

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
        included), cast to each parameter's dtype."""
        self._check_init()
        self.params = self._unflatten(flat, self.params)

    def set_params(self, params: List[Dict[str, Tensor]]):
        """Replace the params with ``params`` (one dict per layer, same
        names and shapes), copied onto the net's device — e.g. from
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
                nd[name] = v.to(device=self.device, dtype=t.dtype)
            new.append(nd)
        self.params = new

    def updater_state_flat(self) -> np.ndarray:
        chunks = [lu[name][s].detach().cpu().numpy().reshape(-1)
                  for lu in self.updater_state for name in sorted(lu)
                  for s in sorted(lu[name])]
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def set_updater_state_flat(self, flat: np.ndarray):
        self._check_init()
        flat = np.asarray(flat)
        off = 0
        new = []
        for lu in self.updater_state:
            nlu = {}
            for name in sorted(lu):
                nlu[name] = {}
                for s in sorted(lu[name]):
                    t = lu[name][s]
                    n = t.numel()
                    nlu[name][s] = torch.as_tensor(
                        flat[off:off + n].reshape(tuple(t.shape))).to(
                        device=t.device, dtype=t.dtype)
                    off += n
            new.append(nlu)
        if off != flat.size:
            raise ValueError(f"Expected {off} updater values, got {flat.size}")
        self.updater_state = new

    # ------------------------------------------------------------- misc ------
    def set_listeners(self, *listeners):
        self.listeners = list(listeners)

    def add_listener(self, listener):
        self.listeners.append(listener)
