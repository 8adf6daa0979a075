"""Convolution + subsampling (pooling) layer impls, NHWC — port of
deeplearning4j_tpu/nn/layers/convolution.py.

The conv runs through the ``conv2d_bias_act`` seam (ops/helpers.py),
whose default is the hand-written CUDA kernel; pooling runs through the
``pool2d`` seam. Activations are NHWC and weights HWIO [kh, kw, c_in,
c_out], as in the JAX package.
"""
from __future__ import annotations

import torch

from .base import LayerImpl, register_impl
from .. import weights as winit
from ...ops import helpers as ophelpers


def _padding_config(conf):
    if conf.convolution_mode == "same":
        return "SAME"
    ph, pw = conf.padding
    return ((ph, ph), (pw, pw))


@register_impl("ConvolutionLayer")
class ConvolutionLayerImpl(LayerImpl):
    def init_params(self, gen, dtype=torch.float32, device=torch.device("cpu")):
        conf = self.conf
        kh, kw = conf.kernel_size
        dist = conf.dist.spec() if getattr(conf, "dist", None) is not None \
            else None
        W = winit.init_weights(gen, (kh, kw, conf.n_in, conf.n_out),
                               conf.weight_init or winit.XAVIER, dtype, device,
                               distribution=dist)
        b = torch.full((conf.n_out,), float(conf.bias_init or 0.0),
                       dtype=dtype, device=device)
        return {"W": W, "b": b}

    def forward(self, params, x, *, train=False, gen=None, mask=None):
        conf = self.conf
        return ophelpers.conv2d_bias_act(
            self._dropout(x, train, gen), params["W"], params["b"],
            stride=conf.stride, padding=_padding_config(conf),
            dilation=conf.dilation, activation=conf.activation or "identity")


@register_impl("SubsamplingLayer")
class SubsamplingLayerImpl(LayerImpl):
    def forward(self, params, x, *, train=False, gen=None, mask=None):
        conf = self.conf
        return ophelpers.pool2d(x, kind=conf.pooling_type,
                                kernel=conf.kernel_size, stride=conf.stride,
                                padding=_padding_config(conf),
                                pnorm=getattr(conf, "pnorm", 2))
