"""The pretrain layers, RBM (CD-k) and the denoising AutoEncoder — port of
deeplearning4j_tpu/nn/layers/pretrain.py.

In a supervised forward both act like a Dense layer (the RBM's hidden
activation by its ``hidden_unit``, the AutoEncoder's encoder). For
layerwise pretraining (`MultiLayerNetwork.pretrain`) they expose:
  - `RBMImpl.cd_gradient`: the CD-k gradient (positive minus negative
    phase statistics), computed directly, as CD is no differentiable loss;
  - `AutoEncoderImpl.pretrain_loss`: the reconstruction loss of a
    corrupted input, differentiated by autograd.

Randomness goes through ``draws``, an object whose ``uniform(i, shape,
device)`` returns the uniforms of draw ``i``: JAX draws a Bernoulli as
``uniform(key) < p`` from the i-th of its split keys, so a test can feed
JAX's own uniforms and hold the gradient against JAX's exactly. The
default, `GeneratorDraws`, takes them from the net's generator. JAX's CD-k
samples only binary units, so it draws no normals.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .base import register_impl
from .feedforward import _LinearLayer
from ...ops import losses as losses_mod

Tensor = torch.Tensor


class GeneratorDraws:
    """Uniform draws from one generator, in call order."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def uniform(self, i: int, shape, device) -> Tensor:
        return torch.rand(tuple(shape), generator=self.gen, device=device)


class _PretrainCore(_LinearLayer):
    def init_params(self, gen, dtype=torch.float32, device=torch.device("cpu")):
        params = super().init_params(gen, dtype, device)
        params["vb"] = torch.zeros((self.conf.n_in,), dtype=dtype,
                                   device=device)  # visible bias
        return params


@register_impl("RBM")
class RBMImpl(_PretrainCore):
    def _hidden_activation(self, pre: Tensor) -> Tensor:
        kind = self.conf.hidden_unit.lower()
        if kind == "binary":
            return torch.sigmoid(pre)
        if kind == "rectified":
            return torch.relu(pre)
        if kind == "gaussian":
            return pre
        if kind == "softmax":
            return torch.softmax(pre, dim=-1)
        raise ValueError(f"Unknown hidden unit '{kind}'")

    def _visible_activation(self, pre: Tensor) -> Tensor:
        kind = self.conf.visible_unit.lower()
        if kind == "binary":
            return torch.sigmoid(pre)
        if kind in ("gaussian", "linear"):
            return pre
        if kind == "softmax":
            return torch.softmax(pre, dim=-1)
        raise ValueError(f"Unknown visible unit '{kind}'")

    def prop_up(self, params, v: Tensor) -> Tensor:
        return self._hidden_activation(v @ params["W"] + params["b"])

    def prop_down(self, params, h: Tensor) -> Tensor:
        return self._visible_activation(h @ params["W"].T + params["vb"])

    def forward(self, params, x, *, train=False, gen=None, mask=None):
        return self.prop_up(params, self._dropout(x, train, gen))

    def cd_gradient(self, params, v0: Tensor, draws, k: int = None
                    ) -> Tuple[Dict[str, Tensor], Tensor]:
        """CD-k gradients (to minimize) and the reconstruction error (JAX
        pretrain.py :83). Draw 0 samples h0, draw 2i+1 the visible units
        of Gibbs step i (binary units only), draw 2i+2 its hidden units."""
        k = k or int(self.conf.k)
        B = v0.shape[0]
        binary_h = self.conf.hidden_unit == "binary"
        binary_v = self.conf.visible_unit == "binary"

        def bernoulli(i, p):
            return (draws.uniform(i, p.shape, p.device) < p).to(v0.dtype)

        h0_prob = self.prop_up(params, v0)
        h = bernoulli(0, h0_prob) if binary_h else h0_prob
        vk = v0
        for i in range(k):
            vk = self.prop_down(params, h)
            if binary_v:
                vk = bernoulli(2 * i + 1, vk)
            hk_prob = self.prop_up(params, vk)
            h = bernoulli(2 * i + 2, hk_prob) if binary_h else hk_prob
        hk_prob = self.prop_up(params, vk)
        # positive - negative phase, averaged over the batch; negated
        gW = -(v0.T @ h0_prob - vk.T @ hk_prob) / B
        gb = -torch.mean(h0_prob - hk_prob, dim=0)
        gvb = -torch.mean(v0 - vk, dim=0)
        recon = losses_mod.mse(v0, self.prop_down(params, h0_prob))
        return {"W": gW, "b": gb, "vb": gvb}, recon


@register_impl("AutoEncoder")
class AutoEncoderImpl(_PretrainCore):
    def encode(self, params, x: Tensor) -> Tensor:
        return self.activation_fn()(x @ params["W"] + params["b"])

    def decode(self, params, h: Tensor) -> Tensor:
        return self.activation_fn()(h @ params["W"].T + params["vb"])

    def forward(self, params, x, *, train=False, gen=None, mask=None):
        return self.encode(params, self._dropout(x, train, gen))

    def pretrain_loss(self, params, x: Tensor, draws) -> Tensor:
        """The denoising reconstruction loss (JAX pretrain.py :121): each
        input unit is zeroed with probability ``corruption_level`` (draw
        0), the rest kept."""
        level = float(self.conf.corruption_level or 0.0)
        if level > 0.0:
            keep = draws.uniform(0, x.shape, x.device) < 1.0 - level
            corrupted = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
        else:
            corrupted = x
        recon = self.decode(params, self.encode(params, corrupted))
        loss_fn = losses_mod.get(self.conf.loss
                                 or "reconstruction_crossentropy")
        return loss_fn(x, recon)
