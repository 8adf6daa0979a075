"""MultiLayerNetwork: the sequential-network facade — port of
deeplearning4j_tpu/nn/multilayer.py (init, forward with the BN+pool pair
fusion, loss, regularization, the hand-written updater step, fit_batch,
fit, output, score and the flat parameter views).

Autograd replaces `jax.value_and_grad`: a train step makes each parameter
a leaf that requires grad, runs the train-mode forward, and takes the
gradients of the batch-mean loss plus the l1/l2 terms with
`torch.autograd.grad`. The update is the JAX package's `_apply_updaters`
written out (gradient normalization, lr schedule, bias lr, the updater's
rule, decoupled weight decay), not `torch.optim`. PyTorch runs eagerly,
so there is no jit cache and no `fit_scan`: `fit` runs one `fit_batch`
per minibatch.

Parameters live on ``device`` (default "cuda"; it raises when no CUDA
device is present — pass device="cpu" to run on the CPU). The conv and
BN+act+pool layers run the port's CUDA kernels there (ops/helpers.py).
Not ported yet, and raising where a config asks for them: solvers other
than SGD, truncated BPTT, layerwise pretraining, remat, recurrent layers,
and any dtype but float32.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .conf.config import BACKPROP_TBPTT, MultiLayerConfiguration
from .conf.preprocessors import (CnnToRnnPreProcessor,
                                 FeedForwardToRnnPreProcessor)
from .layers.base import BaseRecurrentImpl, LayerImpl, impl_for
# importing the impl modules registers them
from .layers import convolution as _convolution
from .layers import feedforward as _feedforward  # noqa: F401
from .layers import normalization as _normalization
from .updater.gradnorm import apply_gradient_normalization
from .updater.schedules import effective_lr
from ..ops import losses as losses_mod
from ..util.device import DeviceLike, resolve_device

Tensor = torch.Tensor

_SGD_ALGOS = ("stochastic_gradient_descent", "sgd")


def _check_supported(conf: MultiLayerConfiguration) -> None:
    g = conf.conf
    if g.dtype != "float32" or g.compute_dtype not in (None, g.dtype):
        raise NotImplementedError(
            f"dtype {g.dtype!r} / compute_dtype {g.compute_dtype!r}: the "
            "port trains float32 nets; bf16 and mixed precision come with "
            "a later slice")
    if g.remat:
        raise NotImplementedError("remat comes with a later slice")
    if conf.pretrain:
        raise NotImplementedError("layerwise pretraining comes with a later "
                                  "slice")
    if (g.optimization_algo or "stochastic_gradient_descent").lower() \
            not in _SGD_ALGOS:
        raise NotImplementedError(
            f"optimization_algo={g.optimization_algo!r}: the port trains "
            "with SGD-family updaters; the line-search solvers come with a "
            "later slice")


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, *,
                 device: DeviceLike = "cuda"):
        _check_supported(conf)
        self.conf = conf
        self.device = resolve_device(device)
        self.dtype = torch.float32
        self._impls: List[LayerImpl] = [impl_for(l) for l in conf.layers]
        for i, impl in enumerate(self._impls):
            if isinstance(impl, BaseRecurrentImpl):
                raise NotImplementedError(
                    f"layer {i} ({type(impl).__name__}): recurrent layers "
                    "in a MultiLayerNetwork come with a later slice")
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
        return t.to(self.dtype) if t.is_floating_point() else t

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
                      upto: Optional[int] = None, fuse_pairs: bool = False,
                      want_preout: bool = False):
        """Forward through layers [0, upto). Returns (activations per
        layer, new variables, the last layer's PRE-activation when
        ``want_preout`` else None).

        ``fuse_pairs`` (set only by the train step, whose activations feed
        nothing but the loss) runs each [BatchNormalization -> 2x2/s2 max
        pool] pair as the one composite op of ops/helpers.bn_act_pool, as
        the JAX package does (multilayer.py :186-210)."""
        conf = self.conf
        n = len(self._impls) if upto is None else upto
        cur = self._adapt_input(x)
        timesteps = cur.shape[1] if cur.ndim == 3 else 1
        acts: List[Tensor] = []
        new_vars = list(variables)
        preout = None
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
            if (train and fuse_pairs and i + 1 < n
                    and isinstance(impl, _normalization.BatchNormalizationImpl)
                    and isinstance(self._impls[i + 1],
                                   _convolution.SubsamplingLayerImpl)
                    and conf.preprocessor(i + 1) is None
                    and impl.can_fuse_pool(impl.conf,
                                           self._impls[i + 1].conf, cur)):
                y, new_vars[i] = impl.forward_fused_pool(
                    params[i], cur, variables=variables[i])
                acts += [y, y]  # both fused layers record the pooled output
                cur = y
                i += 2
                continue
            if (want_preout and i == n - 1
                    and hasattr(impl, "forward_with_preout")):
                y, preout = impl.forward_with_preout(
                    params[i], cur, train=train, gen=gen, mask=mask)
            else:
                y, new_vars[i] = impl.forward_with_variables(
                    params[i], cur, variables[i], train=train, gen=gen,
                    mask=mask)
            acts.append(y)
            cur = y
            i += 1
        return acts, new_vars, preout

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
        x, y = self._as_tensor(x), self._as_tensor(y)
        fmask, lmask = self._as_tensor(fmask), self._as_tensor(lmask)
        params = [{k: v.detach().requires_grad_(True) for k, v in lp.items()}
                  for lp in self.params]
        acts, new_vars, preout = self._forward_impl(
            params, self.variables, x, train=True, gen=self._gen,
            fmask=fmask, fuse_pairs=True, want_preout=True)
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
        return loss.detach(), grads, new_vars

    @torch.no_grad()
    def _apply_updaters(self, params, grads, ustates, step: int):
        """(new params, new updater states) — JAX multilayer.py :262."""
        gconf = self.conf.conf
        new_params, new_ustates = [], []
        for i, layer_conf in enumerate(self.conf.layers):
            lgrads = grads[i]
            if not lgrads:
                new_params.append(params[i])
                new_ustates.append(ustates[i])
                continue
            lgrads = apply_gradient_normalization(
                lgrads, layer_conf.gradient_normalization or "none",
                layer_conf.gradient_normalization_threshold or 1.0)
            updater = layer_conf.updater
            base_lr = updater_lr = getattr(updater, "learning_rate", -1.0)
            if updater_lr is None or updater_lr < 0:
                base_lr = layer_conf.learning_rate
            bias_lr = layer_conf.bias_learning_rate or base_lr
            wd = float(getattr(updater, "weight_decay", 0.0) or 0.0)
            wkeys = self._impls[i].WEIGHT_KEYS
            lp, lu = {}, {}
            for name, g in lgrads.items():
                lr0 = bias_lr if name in ("b", "vb", "beta") else base_lr
                lr = effective_lr(lr0, step, gconf.lr_policy,
                                  gconf.lr_policy_decay_rate,
                                  gconf.lr_policy_power,
                                  gconf.lr_policy_steps,
                                  gconf.max_num_iterations,
                                  gconf.lr_schedule)
                delta, new_state = updater.apply(ustates[i][name], g, lr, step)
                p = params[i][name]
                if wd and name in wkeys:  # decoupled (AdamW-style) decay
                    delta = delta - float(np.float32(lr) * np.float32(wd)) * p
                lp[name] = p + delta
                lu[name] = new_state
            new_params.append(lp)
            new_ustates.append(lu)
        return new_params, new_ustates

    def fit_batch(self, x, y, fmask=None, lmask=None):
        """``conf.iterations`` optimization steps (at least one) on one
        minibatch; the score stays on the device until read."""
        self._check_init()
        x, y = self._as_tensor(x), self._as_tensor(y)
        if self.conf.backprop_type == BACKPROP_TBPTT and x.ndim == 3:
            raise NotImplementedError("truncated BPTT comes with a later "
                                      "slice")
        for _ in range(max(1, self.conf.conf.iterations)):
            loss, grads, new_vars = self.compute_gradient_and_score(
                x, y, fmask, lmask)
            self.params, self.updater_state = self._apply_updaters(
                self.params, grads, self.updater_state, self.step)
            self.variables = new_vars
            self._score_raw = loss
            self.step += 1
            for listener in self.listeners:
                listener.iteration_done(self, self.step)

    # ------------------------------------------------------------------ fit --
    def fit(self, data, labels=None):
        """fit(DataSetIterator) | fit(DataSet) | fit(x, y)."""
        self._check_init()
        if labels is not None:
            self.fit_batch(data, labels)
            return self
        if hasattr(data, "features"):  # one DataSet
            self.fit_batch(data.features, data.labels,
                           getattr(data, "features_mask", None),
                           getattr(data, "labels_mask", None))
            return self
        if self.conf.backprop:
            self._fit_iterator(data)
        return self

    def _fit_iterator(self, iterator):
        """One fit_batch per minibatch of the iterator (iterating resets
        it first). The JAX package's background prefetch and its lax.scan
        chunks have no counterpart here yet."""
        for ds in iterator:
            self.fit_batch(ds.features, ds.labels,
                           getattr(ds, "features_mask", None),
                           getattr(ds, "labels_mask", None))

    # ---------------------------------------------------------- inference ----
    @torch.no_grad()
    def output(self, x, train: bool = False, fmask=None) -> Tensor:
        """The network output on the net's device. train=True applies
        train-mode dropout and batch statistics (the running statistics
        are not updated)."""
        self._check_init()
        acts, _, _ = self._forward_impl(
            self.params, self.variables, self._as_tensor(x), train=train,
            gen=self._gen if train else None, fmask=self._as_tensor(fmask))
        return acts[-1]

    def predict(self, x) -> np.ndarray:
        return self.output(x).argmax(dim=-1).cpu().numpy()

    @torch.no_grad()
    def feed_forward(self, x, train: bool = False) -> List[Tensor]:
        """All layer activations, the input first."""
        self._check_init()
        x = self._as_tensor(x)
        acts, _, _ = self._forward_impl(self.params, self.variables, x,
                                        train=train,
                                        gen=self._gen if train else None)
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
        acts, _, preout = self._forward_impl(
            self.params, self.variables, self._as_tensor(x), train=False,
            fmask=self._as_tensor(fmask), want_preout=True)
        loss = self._loss_from_output(acts[-1], self._as_tensor(y),
                                      self._as_tensor(lmask), preout=preout)
        return float(loss + self._reg_loss(self.params))

    # ------------------------------------------------------------ params -----
    def num_params(self) -> int:
        return int(sum(p.numel() for lp in self.params for p in lp.values()))

    def params_flat(self) -> np.ndarray:
        """Flat parameter view in (layer, sorted name) order — the order of
        the model zip's ``coefficients.bin``, shared with the JAX package."""
        chunks = [lp[name].detach().cpu().numpy().reshape(-1)
                  for lp in self.params for name in sorted(lp)]
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def _unflatten(self, flat, like):
        flat = np.asarray(flat)
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
