"""Dense / RnnOutput layer impls — port of the part of
deeplearning4j_tpu/nn/layers/feedforward.py that ``transformer_lm`` runs.

Weights keep the JAX layout ``W: [n_in, n_out]`` and compute
``x @ W + b`` (no transpose into `torch.nn.Linear`'s [out, in]), so the
flat parameter order and the zip format are shared with the JAX package.
"""
from __future__ import annotations

import torch

from .base import LayerImpl, register_impl
from .. import weights as winit


class _LinearLayer(LayerImpl):
    def init_params(self, gen, dtype=torch.float32, device=torch.device("cpu")):
        conf = self.conf
        W = winit.init_weights(gen, (conf.n_in, conf.n_out),
                               conf.weight_init or winit.XAVIER, dtype, device)
        b = torch.full((conf.n_out,), float(conf.bias_init or 0.0),
                       dtype=dtype, device=device)
        return {"W": W, "b": b}

    def forward(self, params, x, *, mask=None):
        return self.activation_fn()(x @ params["W"] + params["b"])


@register_impl("DenseLayer")
class DenseLayerImpl(_LinearLayer):
    pass


@register_impl("RnnOutputLayer")
class RnnOutputLayerImpl(_LinearLayer):
    """Per-timestep output: [B, T, F] -> [B, T, n_out]."""

    def forward(self, params, x, *, mask=None):
        y = self.activation_fn()(x @ params["W"] + params["b"])
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y
