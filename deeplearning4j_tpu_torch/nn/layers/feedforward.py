"""Feed-forward layer impls — port of
deeplearning4j_tpu/nn/layers/feedforward.py: Dense, Output, RnnOutput,
Loss, Activation, Dropout, GlobalPooling and Embedding.

Weights keep the JAX layout ``W: [n_in, n_out]`` and compute
``x @ W + b`` (no transpose into `torch.nn.Linear`'s [out, in]), so the
flat parameter order and the zip format are shared with the JAX package.
Input dropout applies at train time, before the product.
"""
from __future__ import annotations

import torch

from .base import LayerImpl, register_impl
from .. import weights as winit
from ...parallel.tp_autograd import copy_to_tp, gather_from_tp, reduce_from_tp


class _LinearLayer(LayerImpl):
    # tensor parallelism (inference/sharding.py): a row-split layer's
    # communicator (all-reduce of the partial product before the bias),
    # or a column-split one whose output is gathered back; in training
    # also a column-split layer's input communicator (copy_to_tp,
    # parallel/tp_autograd.py)
    tp_comm = None
    tp_gather = None
    tp_copy = None

    def init_params(self, gen, dtype=torch.float32, device=torch.device("cpu")):
        conf = self.conf
        dist = conf.dist.spec() if getattr(conf, "dist", None) is not None \
            else None
        W = winit.init_weights(gen, (conf.n_in, conf.n_out),
                               conf.weight_init or winit.XAVIER, dtype, device,
                               distribution=dist)
        b = torch.full((conf.n_out,), float(conf.bias_init or 0.0),
                       dtype=dtype, device=device)
        return {"W": W, "b": b}

    def forward(self, params, x, *, train=False, gen=None, mask=None):
        return self.forward_with_preout(params, x, train=train, gen=gen,
                                        mask=mask)[0]

    def forward_with_preout(self, params, x, *, train=False, gen=None,
                            mask=None):
        """(activations, PRE-activation): the loss path feeds the
        pre-activation to the from-logits losses (ops/losses.py)."""
        z = copy_to_tp(self.tp_copy, self._dropout(x, train, gen)) \
            @ params["W"]
        if self.tp_comm is not None:
            z = reduce_from_tp(self.tp_comm, z)
        z = z + params["b"]
        if self.tp_gather is not None:
            z = gather_from_tp(self.tp_gather, z)
        return self.activation_fn()(z), z


@register_impl("DenseLayer")
class DenseLayerImpl(_LinearLayer):
    pass


@register_impl("OutputLayer")
class OutputLayerImpl(_LinearLayer):
    """Output layer; the network computes the loss from conf.loss."""


@register_impl("RnnOutputLayer")
class RnnOutputLayerImpl(_LinearLayer):
    """Per-timestep output: [B, T, F] -> [B, T, n_out]."""

    def forward_with_preout(self, params, x, *, train=False, gen=None,
                            mask=None):
        y, z = super().forward_with_preout(params, x, train=train, gen=gen)
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y, z


@register_impl("LossLayer")
class LossLayerImpl(LayerImpl):
    """No params: the activation of its input, whose pre-activation is the
    input itself (so the from-logits losses apply to a net ending in
    LossLayer(softmax, mcxent))."""

    def forward(self, params, x, *, train=False, gen=None, mask=None):
        return self.activation_fn()(x)

    def forward_with_preout(self, params, x, *, train=False, gen=None,
                            mask=None):
        return self.activation_fn()(x), x


@register_impl("ActivationLayer")
class ActivationLayerImpl(LayerImpl):
    def forward(self, params, x, *, train=False, gen=None, mask=None):
        return self.activation_fn()(self._dropout(x, train, gen))


@register_impl("DropoutLayer")
class DropoutLayerImpl(LayerImpl):
    def forward(self, params, x, *, train=False, gen=None, mask=None):
        return self._dropout(x, train, gen)


@register_impl("GlobalPoolingLayer")
class GlobalPoolingLayerImpl(LayerImpl):
    """Pool over time ([B, T, F] -> [B, F]) or space ([B, H, W, C] ->
    [B, C]); a [B, T] mask applies to the time series of max, avg and
    sum (JAX feedforward.py :127: pnorm takes no mask)."""

    def forward(self, params, x, *, train=False, gen=None, mask=None):
        pool = self.conf.pooling_type.lower()
        dims = (1,) if x.ndim == 3 else (1, 2)
        m = (mask[..., None].to(x.dtype)
             if mask is not None and x.ndim == 3 else None)
        if pool == "max":
            if m is not None:
                x = torch.where(m > 0, x, torch.full(
                    (), torch.finfo(x.dtype).min, dtype=x.dtype,
                    device=x.device))
            return torch.amax(x, dim=dims)
        if pool in ("avg", "mean"):
            if m is not None:
                return torch.sum(x * m, dim=dims) / torch.clamp(
                    torch.sum(m, dim=dims), min=1.0)
            return torch.mean(x, dim=dims)
        if pool == "sum":
            return torch.sum(x if m is None else x * m, dim=dims)
        if pool == "pnorm":
            p = float(getattr(self.conf, "pnorm", 2))
            return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=dims),
                             1.0 / p)
        raise ValueError(f"Unknown pooling type {pool}")


@register_impl("EmbeddingLayer")
class EmbeddingLayerImpl(LayerImpl):
    """Row lookup: integer indices [B] or [B, 1] (the first column of a
    wider index array), or one-hot rows [B, n_in] (a product with W).

    Indices follow `jnp.take` (JAX feedforward.py :172), established by
    test: a negative index counts from the end once (-1 is the last row),
    and a row outside [-n_in, n_in) is NaN with no gradient. The gather
    runs on a clamped index and `torch.where` puts the NaN in place, so
    no index ever leaves the table (on the card an out-of-range gather
    trips a device-side assert) and no value is read back to check."""

    def init_params(self, gen, dtype=torch.float32,
                    device=torch.device("cpu")):
        conf = self.conf
        dist = conf.dist.spec() if getattr(conf, "dist", None) is not None \
            else None
        params = {"W": winit.init_weights(
            gen, (conf.n_in, conf.n_out), conf.weight_init or winit.XAVIER,
            dtype, device, distribution=dist)}
        if getattr(conf, "has_bias", True):
            params["b"] = torch.full((conf.n_out,),
                                     float(conf.bias_init or 0.0),
                                     dtype=dtype, device=device)
        return params

    def forward(self, params, x, *, train=False, gen=None, mask=None):
        W = params["W"]
        n = self.conf.n_in
        if x.is_floating_point() and x.ndim == 2 and x.shape[-1] == n:
            out = x @ W  # one-hot rows
        else:
            idx = x.reshape(x.shape[0], -1)[:, 0] if x.ndim > 1 else x
            idx = idx.to(torch.int64)
            idx = torch.where(idx < 0, idx + n, idx)
            valid = ((idx >= 0) & (idx < n))[:, None]
            rows = W[idx.clamp(0, n - 1)]
            out = torch.where(valid, rows, torch.full(
                (), float("nan"), dtype=W.dtype, device=W.device))
        if "b" in params:
            out = out + params["b"]
        return self.activation_fn()(out)
