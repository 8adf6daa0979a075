"""BatchNormalization, LocalResponseNormalization and LayerNormalization
impls — port of deeplearning4j_tpu/nn/layers/normalization.py.

Variances are POPULATION variances, as `jnp.var` computes them
(``unbiased=False``; torch's default is the unbiased estimator).

BatchNormalization keeps its running ``mean`` and ``var`` in the layer's
``variables``: train mode normalizes with the batch statistics and
returns the EMA ``decay * old + (1 - decay) * batch`` (computed without
gradient); inference mode, and ``use_global_stats``, normalize with the
running statistics.
"""
from __future__ import annotations

import torch

from .base import LayerImpl, register_impl
from ...ops import helpers as ophelpers


@register_impl("BatchNormalization")
class BatchNormalizationImpl(LayerImpl):
    WEIGHT_KEYS = ()  # gamma/beta are not regularized

    def init_params(self, gen, dtype=torch.float32, device=torch.device("cpu")):
        conf = self.conf
        if conf.lock_gamma_beta:
            return {}
        n = conf.n_out
        return {"gamma": torch.full((n,), float(conf.gamma), dtype=dtype,
                                    device=device),
                "beta": torch.full((n,), float(conf.beta), dtype=dtype,
                                   device=device)}

    def init_variables(self, dtype=torch.float32, device=torch.device("cpu")):
        n = self.conf.n_out
        return {"mean": torch.zeros((n,), dtype=dtype, device=device),
                "var": torch.ones((n,), dtype=dtype, device=device)}

    def _gamma_beta(self, params, x):
        conf = self.conf
        if conf.lock_gamma_beta:
            return (torch.full((conf.n_out,), float(conf.gamma),
                               dtype=x.dtype, device=x.device),
                    torch.full((conf.n_out,), float(conf.beta),
                               dtype=x.dtype, device=x.device))
        return params["gamma"], params["beta"]

    def _ema(self, variables, mean, var):
        vdt = variables["mean"].dtype
        # the decay in the variables' dtype, so 1 - d rounds as in JAX;
        # filled on the device (a captured step copies nothing from the
        # host)
        d = torch.full((), float(self.conf.decay), dtype=vdt,
                       device=variables["mean"].device)
        with torch.no_grad():
            return {"mean": d * variables["mean"]
                    + (1.0 - d) * mean.detach().to(vdt),
                    "var": d * variables["var"]
                    + (1.0 - d) * var.detach().to(vdt)}

    def forward(self, params, x, *, train=False, gen=None, mask=None):
        return self.forward_with_variables(
            params, x, self.init_variables(x.dtype, x.device),
            train=train)[0]

    def forward_with_variables(self, params, x, variables, *, train=False,
                               gen=None, mask=None):
        conf = self.conf
        gamma, beta = self._gamma_beta(params, x)
        if train and not conf.use_global_stats:
            # global over the ranks inside ophelpers.bn_sync
            mean32, var32 = ophelpers.batch_stats(x)
            mean, var = mean32.to(x.dtype), var32.to(x.dtype)
            new_vars = self._ema(variables, mean32, var32)
        else:
            mean, var = variables["mean"], variables["var"]
            new_vars = variables
        y = ophelpers.batch_norm(x, gamma, beta, mean, var, eps=conf.eps)
        if conf.activation not in (None, "identity", "linear"):
            y = self.activation_fn()(y)
        return y, new_vars

    def forward_fused_pool(self, params, x, *, variables):
        """Train-mode BN + activation + the FOLLOWING 2x2/s2 max-pool layer
        as one composite op (ops/helpers.bn_act_pool), whose backward is
        the two CUDA kernels. Engaged by the network when the layer pair
        matches (`can_fuse_pool`); the values are those of running the two
        layers one after the other. Returns (pooled, new variables)."""
        gamma, beta = self._gamma_beta(params, x)
        y, mean32, var32 = ophelpers.bn_act_pool(
            x, gamma, beta, eps=self.conf.eps,
            activation=self.conf.activation or "identity")
        return y, self._ema(variables, mean32, var32)

    @staticmethod
    def can_fuse_pool(bn_conf, pool_conf, x) -> bool:
        """True when [this BN layer -> pool_conf] matches the composite:
        batch stats, a 2x2/s2 max pool with no effective padding, even
        spatial dims (JAX normalization.py :91)."""
        return (x.ndim == 4
                and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
                and not bn_conf.use_global_stats
                and pool_conf.pooling_type == "max"
                and tuple(pool_conf.kernel_size) == (2, 2)
                and tuple(pool_conf.stride) == (2, 2)
                and (pool_conf.convolution_mode == "same"
                     or tuple(pool_conf.padding) == (0, 0)))


@register_impl("LocalResponseNormalization")
class LocalResponseNormalizationImpl(LayerImpl):
    """Cross-channel LRN over the `lrn` seam (ops/helpers.py), NHWC."""

    def forward(self, params, x, *, train=False, gen=None, mask=None):
        c = self.conf
        return ophelpers.lrn(x, k=c.k, n=c.n, alpha=c.alpha, beta=c.beta)


@register_impl("LayerNormalization")
class LayerNormalizationImpl(LayerImpl):
    def init_params(self, gen, dtype=torch.float32, device=torch.device("cpu")):
        n = self.conf.n_out or self.conf.n_in
        return {"gain": torch.ones((n,), dtype=dtype, device=device),
                "beta": torch.zeros((n,), dtype=dtype, device=device)}

    def forward(self, params, x, *, train=False, gen=None, mask=None):
        conf = self.conf
        x = self._dropout(x, train, gen)
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        # eps in x's dtype, as JAX adds it (normalization.py :130); an f32
        # x takes the Python float, the same f32 scalar
        eps = conf.eps if x.dtype == torch.float32 else torch.full(
            (), conf.eps, dtype=x.dtype, device=x.device)
        y = (x - mean) * torch.rsqrt(var + eps)
        y = y * params["gain"] + params["beta"]
        if conf.activation not in (None, "identity", "linear"):
            y = self.activation_fn()(y)
        return y
