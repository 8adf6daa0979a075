"""Dense / Output / RnnOutput layer impls — port of the linear layers of
deeplearning4j_tpu/nn/layers/feedforward.py.

Weights keep the JAX layout ``W: [n_in, n_out]`` and compute
``x @ W + b`` (no transpose into `torch.nn.Linear`'s [out, in]), so the
flat parameter order and the zip format are shared with the JAX package.
Input dropout applies at train time, before the product.
"""
from __future__ import annotations

import torch

from .base import LayerImpl, register_impl
from .. import weights as winit


class _LinearLayer(LayerImpl):
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
        z = self._dropout(x, train, gen) @ params["W"] + params["b"]
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
