"""Accelerated-op helper seam — port of deeplearning4j_tpu/ops/helpers.py
(the registry and the conv / pool / batch-norm / BN+act+pool /
paged-decode seams; the LSTM and full-sequence attention seams come with
the slices that run them).

A registry of op implementations: `register_helper(name, fn)` overrides
an op, `register_helper(name, None)` restores its default. Where the JAX
package has a Pallas kernel, the port's default is the hand-written CUDA
kernel (`ops/cuda_kernels.py`): kernel on CUDA tensors, plain version on
CPU tensors. There is no per-shape autotune and no silent fallback on the
card. A seam runs its plain default only in the cases the JAX kernel
declines as well (its decline rules are copied here), or when the caller
registers an override, e.g. `PLAIN_OVERRIDES`.

Layout: activations NHWC, conv weights HWIO, as in the JAX package, so
parameters carry across without a transpose; only the plain versions
permute, for `F.conv2d` and `F.max_pool2d`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import activations
from . import cuda_kernels as ck

Tensor = torch.Tensor

_HELPERS: Dict[str, Callable] = {}


def register_helper(name: str, fn: Optional[Callable]) -> None:
    """Override the implementation of an op; None restores the default."""
    if fn is None:
        _HELPERS.pop(name, None)
    else:
        _HELPERS[name] = fn


def get_helper(name: str) -> Optional[Callable]:
    return _HELPERS.get(name)


def _pad_key(padding):
    return padding if isinstance(padding, str) else tuple(
        tuple(int(v) for v in p) for p in padding)


# -- conv2d --------------------------------------------------------------------

def _conv2d_default(x, w, *, stride, padding, dilation=(1, 1)):
    return ck.conv2d_ref(x, w, stride=stride, padding=padding,
                         dilation=dilation)


def conv2d(x: Tensor, w: Tensor, *, stride=(1, 1), padding="SAME",
           dilation=(1, 1)) -> Tensor:
    """NHWC x HWIO -> NHWC convolution."""
    impl = _HELPERS.get("conv2d", _conv2d_default)
    return impl(x, w, stride=stride, padding=padding, dilation=dilation)


# -- fused conv2d + bias + activation -----------------------------------------

def _conv2d_bias_act_default(x, w, b, *, stride, padding, dilation,
                             activation):
    # through the public conv2d seam, so a 'conv2d' override still applies
    y = conv2d(x, w, stride=stride, padding=padding, dilation=dilation)
    return activations.get(activation)(y + b)


def conv_kernel_applies(w: Tensor, dilation) -> bool:
    """The JAX seam's rule (pallas_kernels.py :200): no dilation and a
    contraction row kw*c of at least 8."""
    return tuple(dilation) == (1, 1) and w.shape[1] * w.shape[2] >= 8


def _conv_backward(x, w, gz, stride, padding, need):
    """(dx, dw, db) of z = conv(x, w) + b at the output gradient ``gz``
    (NHWC x, HWIO w), None where ``need`` is False: one
    aten.convolution_backward on NCHW/OIHW views. Symmetric pads go to it
    as its own padding; asymmetric ones (SAME with an odd total) pad x
    first and crop dx."""
    H, W = x.shape[1], x.shape[2]
    _, _, ((pt, pb), (pl, pr)) = ck.conv_geometry(H, W, w.shape[0],
                                                  w.shape[1], stride, padding)
    if pt == pb and pl == pr:
        xin, conv_pad = x, [pt, pl]
    else:
        xin, conv_pad = F.pad(x, (0, 0, pl, pr, pt, pb)), [0, 0]
    dx, dw, db = torch.ops.aten.convolution_backward(
        gz.permute(0, 3, 1, 2), xin.permute(0, 3, 1, 2),
        w.permute(3, 2, 0, 1), [w.shape[3]], list(stride), conv_pad, [1, 1],
        False, [0, 0], 1, list(need))
    if dx is not None:
        dx = dx.permute(0, 2, 3, 1)
        if xin is not x:
            dx = dx[:, pt:pt + H, pl:pl + W, :]
    if dw is not None:
        dw = dw.permute(2, 3, 1, 0)
    return dx, dw, db


class _ConvBiasAct(torch.autograd.Function):
    """Forward: the conv kernel's wrapper. Backward: the gradient of the
    plain default, as the JAX custom_vjp takes the VJP of the XLA default
    (pallas_kernels.py :182; no backward kernel exists to port), from
    saved tensors and without recomputing the forward: the activation's
    derivative at the pre-activation that the kernel writes beside its
    output (identity needs none), then the conv's three gradients."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, activation):
        keep_pre = (activation not in ("identity", "linear")
                    and any(ctx.needs_input_grad[:3]))
        out = ck.conv2d_bias_act(x.contiguous(), w.contiguous(),
                                 b.contiguous(), stride=stride,
                                 padding=padding, activation=activation,
                                 want_pre=keep_pre)
        y, pre = out if keep_pre else (out, None)
        ctx.save_for_backward(x, w, pre)
        ctx.conf = (stride, padding, activation)
        return y

    @staticmethod
    def backward(ctx, g):
        stride, padding, activation = ctx.conf
        x, w, pre = ctx.saved_tensors
        gz = g
        if pre is not None:
            with torch.enable_grad():
                z = pre.detach().requires_grad_(True)
                gz, = torch.autograd.grad(activations.get(activation)(z), z,
                                          g)
        return _conv_backward(x, w, gz, stride, padding,
                              ctx.needs_input_grad[:3]) + (None,) * 3


def conv2d_bias_act(x: Tensor, w: Tensor, b: Tensor, *, stride=(1, 1),
                    padding="SAME", dilation=(1, 1),
                    activation="identity") -> Tensor:
    """Fused NHWC conv + bias + activation (JAX helpers.py :72): the CUDA
    kernel, or the plain default where the JAX kernel declines too.
    "softmax", the one activation that is not elementwise, runs the
    kernel's identity epilogue and then the channel softmax: the JAX
    kernel applies it to its whole-OC output block."""
    impl = _HELPERS.get("conv2d_bias_act")
    if impl is not None:
        return impl(x, w, b, stride=stride, padding=padding,
                    dilation=dilation, activation=activation)
    if not conv_kernel_applies(w, dilation):
        return _conv2d_bias_act_default(x, w, b, stride=stride,
                                        padding=padding, dilation=dilation,
                                        activation=activation)
    act = str(activation).lower()
    conv = (tuple(int(s) for s in stride), _pad_key(padding))
    if act == "softmax":
        return activations.softmax(_ConvBiasAct.apply(x, w, b, *conv,
                                                      "identity"))
    return _ConvBiasAct.apply(x, w, b, *conv, act)


# -- pool2d --------------------------------------------------------------------

def _pool_pads(h, w, kernel, stride, padding):
    if padding == "SAME":
        _, _, pads = ck.conv_geometry(h, w, kernel[0], kernel[1], stride,
                                      "SAME")
        return pads
    return tuple(tuple(int(v) for v in p) for p in padding)


def _pool2d_default(x, *, kind, kernel, stride, padding, pnorm=2):
    """`lax.reduce_window` over NHWC, as the JAX default: the pads are
    applied first (with -inf for max, zeros otherwise), and "avg" divides
    by the count of real (unpadded) inputs in each window."""
    (pt, pb), (pl, pr) = _pool_pads(x.shape[1], x.shape[2], kernel, stride,
                                    padding)
    kind = kind.lower()
    xc = x.permute(0, 3, 1, 2)
    k, s = tuple(kernel), tuple(stride)

    def window_sum(t):
        tp = F.pad(t, (pl, pr, pt, pb))
        return F.avg_pool2d(tp, k, s, divisor_override=1)

    if kind == "max":
        y = F.max_pool2d(F.pad(xc, (pl, pr, pt, pb), value=float("-inf")),
                         k, s)
    elif kind in ("avg", "mean"):
        y = window_sum(xc) / window_sum(torch.ones_like(xc))
    elif kind == "sum":
        y = window_sum(xc)
    elif kind == "pnorm":
        p = float(pnorm)
        y = torch.pow(window_sum(torch.pow(torch.abs(xc), p)), 1.0 / p)
    else:
        raise ValueError(f"Unknown pooling kind '{kind}'")
    return y.permute(0, 2, 3, 1)


def pool2d(x: Tensor, *, kind="max", kernel=(2, 2), stride=(2, 2),
           padding="SAME", pnorm=2) -> Tensor:
    impl = _HELPERS.get("pool2d", _pool2d_default)
    return impl(x, kind=kind, kernel=kernel, stride=stride, padding=padding,
                pnorm=pnorm)


# -- batch norm ----------------------------------------------------------------

def _batch_norm_default(x, gamma, beta, mean, var, *, eps):
    inv = torch.rsqrt(var + eps)
    return (x - mean) * inv * gamma + beta


def batch_norm(x, gamma, beta, mean, var, *, eps=1e-5) -> Tensor:
    impl = _HELPERS.get("batch_norm", _batch_norm_default)
    return impl(x, gamma, beta, mean, var, eps=eps)


def bn_batch_stats(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-channel batch (mean, var) over all but the last axis (JAX
    helpers.py :180): two-pass biased variance for f32 and f64; one-pass
    E[x^2] - E[x]^2 in f32 for sub-f32 inputs."""
    dims = tuple(range(x.ndim - 1))
    if x.dtype in (torch.bfloat16, torch.float16):
        xf = x.float()
        mean = torch.mean(xf, dim=dims)
        var = torch.clamp_min(torch.mean(xf * xf, dim=dims) - mean * mean,
                              0.0)
        return mean, var
    return torch.mean(x, dim=dims), torch.var(x, dim=dims, unbiased=False)


# -- fused train-mode BatchNorm + activation + 2x2/s2 max-pool ----------------

def _bn_act_pool_default(x, gamma, beta, *, eps, activation):
    mean, var = bn_batch_stats(x)
    y = batch_norm(x, gamma, beta, mean.to(x.dtype), var.to(x.dtype),
                   eps=eps)
    y = activations.get(activation)(y)
    y = pool2d(y, kind="max", kernel=(2, 2), stride=(2, 2), padding="SAME")
    return y, mean.detach(), var.detach()


def bnap_kernel_applies(x: Tensor, activation) -> bool:
    """The JAX seam's rule (pallas_kernels.py :551): an activation of
    `_BNAP_ACTS`, even H and W, C % 8 == 0 and W >= 4."""
    _, H, W, C = x.shape
    return (activation in ck.BNAP_ACTS and H % 2 == 0 and W % 2 == 0
            and C % 8 == 0 and W >= 4)


class _BnActPool(torch.autograd.Function):
    """Forward: the plain chain (JAX `fwd_chain` :332). Backward: the sums
    pass, then the dx pass (`fn_bwd` :356), through ``sums`` and ``dx``
    (the kernels' wrappers, or their plain versions). The stats outputs
    carry no gradient, as the JAX seam stop-gradients them (:568)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, activation, sums, dx):
        pooled, mean, var, inv = ck.bnap_forward_ref(
            x, gamma, beta, eps=eps, activation=activation)
        ctx.save_for_backward(x, gamma, beta, mean, inv)
        ctx.conf = (activation, sums, dx)
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, gamma, beta, mean, inv = ctx.saved_tensors
        activation, sums, dx = ctx.conf
        x = x.contiguous()
        g = g.contiguous()
        p = torch.stack([mean, inv, gamma.float(), beta.float()])
        dgamma, dbeta = sums(x, g, p, activation=activation)
        dx_ = dx(x, g, p, torch.stack([dbeta, dgamma]), activation=activation)
        return (dx_, dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
                None, None, None, None)


def bn_act_pool_plain(x, gamma, beta, *, eps=1e-5, activation="relu"):
    """The composite with the PLAIN versions of both backward passes: what
    the kernels compute, in PyTorch ops, on any device."""
    return _BnActPool.apply(x, gamma, beta, float(eps), activation,
                            ck.bnap_sums_ref, ck.bnap_dx_ref)


def bn_act_pool(x, gamma, beta, *, eps=1e-5, activation="relu"):
    """Train-mode batch norm (batch stats) + activation + 2x2/s2 max-pool as
    ONE composite op, returning (pooled, batch_mean, batch_var), the stats
    without gradient (JAX helpers.py :211). Its backward is the two CUDA
    kernels, or the plain default where the JAX kernel declines too.
    Requires x [B, H, W, C] with even H and W."""
    impl = _HELPERS.get("bn_act_pool")
    if impl is not None:
        return impl(x, gamma, beta, eps=eps, activation=activation)
    if not bnap_kernel_applies(x, activation):
        return _bn_act_pool_default(x, gamma, beta, eps=eps,
                                    activation=activation)
    return _BnActPool.apply(x, gamma, beta, float(eps), activation,
                            ck.bnap_sums, ck.bnap_dx)


# The caller's explicit way around every training kernel: register these to
# run each kernel's plain version instead, on any device.
PLAIN_OVERRIDES = {"conv2d_bias_act": _conv2d_bias_act_default,
                   "bn_act_pool": bn_act_pool_plain}


# -- fused paged-attention decode ----------------------------------------------

def _paged_decode_default(q, k_pages, v_pages, table, pos, *, k_scales=None,
                          v_scales=None):
    return ck.paged_decode_attention(q, k_pages, v_pages, table, pos,
                                     k_scales=k_scales, v_scales=v_scales)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, table: torch.Tensor,
                           pos: torch.Tensor, *, k_scales=None,
                           v_scales=None, mode: str = "on"):
    """Paged-KV decode attention seam (JAX: helpers.py:265).

    ``q``: [B, 1, H, Dh] single-token queries (RoPE applied);
    ``k_pages``/``v_pages``: [pages, block, Hkv, Dh] AFTER this step's
    write (page 0 = scratch); ``table``: [B, nb] int32; ``pos``: [B]
    int32 — row b attends over positions [0, pos[b]];
    ``k_scales``/``v_scales``: [pages, block, Hkv] f32 for int8 pages.
    ``mode``: "on" runs the kernel, "off" is the caller's explicit choice
    of its gather body.

    Returns [B, 1, H, Dh], or None — mode "off", T != 1, a query dtype
    other than f32, or H not a multiple of Hkv — and the caller then runs
    its own gather body, as in the JAX package."""
    B, T, H, Dh = q.shape
    Hkv = k_pages.shape[2]
    if mode == "off" or T != 1 or q.dtype != torch.float32 or H % Hkv:
        return None
    if mode != "on":
        raise ValueError(f"paged decode mode must be 'on' or 'off', "
                         f"got {mode!r}")
    impl = _HELPERS.get("paged_decode_attention", _paged_decode_default)
    return impl(q, k_pages, v_pages, table, pos, k_scales=k_scales,
                v_scales=v_scales)
