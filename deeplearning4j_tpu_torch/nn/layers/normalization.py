"""LayerNormalization impl — port of the LayerNormalization part of
deeplearning4j_tpu/nn/layers/normalization.py (BatchNorm and LRN come
with the training slice).

The variance is the POPULATION variance, as `jnp.var` computes it
(``unbiased=False``; torch's default is the unbiased estimator), and eps
comes from the conf.
"""
from __future__ import annotations

import torch

from .base import LayerImpl, register_impl


@register_impl("LayerNormalization")
class LayerNormalizationImpl(LayerImpl):
    def init_params(self, gen, dtype=torch.float32, device=torch.device("cpu")):
        n = self.conf.n_out or self.conf.n_in
        return {"gain": torch.ones((n,), dtype=dtype, device=device),
                "beta": torch.zeros((n,), dtype=dtype, device=device)}

    def forward(self, params, x, *, mask=None):
        conf = self.conf
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        y = (x - mean) * torch.rsqrt(var + conf.eps)
        y = y * params["gain"] + params["beta"]
        if conf.activation not in (None, "identity", "linear"):
            y = self.activation_fn()(y)
        return y
