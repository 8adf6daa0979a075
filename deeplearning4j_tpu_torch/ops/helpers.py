"""Accelerated-op helper seam — port of deeplearning4j_tpu/ops/helpers.py
(the registry and the conv / pool / batch-norm / BN+act+pool / LSTM
sequence / LRN / full-sequence attention (flash below SPLASH_MIN_LEN,
splash from it) / paged-decode seams). The LSTM sequence and LRN seams
have no kernel in either package (JAX retired its LSTM kernel,
pallas_kernels.py :211-230): their defaults are plain PyTorch.

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

import contextlib
import functools
import math
import threading
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from . import activations
from . import cuda_kernels as ck
from . import splash_mask

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
    kernel of x's dtype (f32 or bf16), or the plain default where the JAX
    kernel declines too.
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


def conv2d_bias_act_plain(x, w, b, *, stride=(1, 1), padding="SAME",
                          dilation=(1, 1), activation="identity"):
    """The seam with the kernel's PLAIN version in its place, on any
    device, differentiated by autograd (independent of `_ConvBiasAct`'s
    backward). At f32 it is the plain default; at bf16 it rounds as the
    kernel does, once after the activation, where the plain default rounds
    the conv and the bias too."""
    if not conv_kernel_applies(w, dilation):
        return _conv2d_bias_act_default(x, w, b, stride=stride,
                                        padding=padding, dilation=dilation,
                                        activation=activation)
    act = str(activation).lower()
    conv = dict(stride=tuple(int(s) for s in stride), padding=padding)
    if act == "softmax":
        return activations.softmax(ck.conv2d_bias_act_ref(
            x, w, b, activation="identity", **conv))
    return ck.conv2d_bias_act_ref(x, w, b, activation=act, **conv)


# -- fused LSTM sequence -------------------------------------------------------

def lstm_cell(z, c_prev, peep, act_fn):
    """One LSTM cell step from pre-activations z = x W + b + h RW (JAX
    helpers.py :85). Gate packing [i, f, o, g]; ``peep`` = (pI, pF, pO)
    peephole weights (zeros for a plain LSTM): i and f see c_prev, o sees
    the new c. THE single definition of the cell math, shared by the
    sequence default below and the recurrent layers' per-step path
    (masked sequences, rnn_time_step)."""
    H = c_prev.shape[-1]
    i = torch.sigmoid(z[..., :H] + c_prev * peep[0])
    f = torch.sigmoid(z[..., H:2 * H] + c_prev * peep[1])
    g = act_fn(z[..., 3 * H:])
    c = f * c_prev + i * g
    o = torch.sigmoid(z[..., 2 * H:3 * H] + c * peep[2])
    h = o * act_fn(c)
    return h, c


def _lstm_sequence_default(xproj_t, rw, peep, h0, c0, *, activation,
                           reverse):
    """The port of JAX's `lax.scan` default: a Python loop over T, each
    step ``xp + h @ rw`` then `lstm_cell`; with ``reverse`` the walk runs
    from T-1 down to 0 and y[t] still lands at index t."""
    act_fn = activations.get(activation)
    T = xproj_t.shape[0]
    h, c = h0, c0
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c = lstm_cell(xproj_t[t] + h @ rw, c, peep, act_fn)
        ys[t] = h
    return torch.stack(ys), h, c


def lstm_sequence(xproj_t: Tensor, rw: Tensor, peep: Tensor, h0: Tensor,
                  c0: Tensor, *, activation="tanh", reverse=False):
    """LSTM over a pre-projected sequence (JAX helpers.py :114). xproj_t:
    [T, B, 4H] = x W + b for all timesteps; gate packing [i, f, o, g];
    peep: [3, H] peephole weights (zeros: plain LSTM). Returns (ys [T, B,
    H], h_T, c_T)."""
    impl = _HELPERS.get("lstm_sequence", _lstm_sequence_default)
    return impl(xproj_t, rw, peep, h0, c0, activation=activation,
                reverse=reverse)


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


# Per-channel batch (mean, var) over all but the last axis (JAX helpers.py
# :180); the kernels' module holds it, as the composite's forward uses it.
bn_batch_stats = ck.bn_batch_stats


# -- data-parallel batch statistics ------------------------------------------
# GSPMD keeps single-program semantics, so under the JAX package's ICI
# data-parallel master a BatchNorm's batch statistics are those of the
# global (sharded) batch. The port's ranks are processes: inside
# `bn_sync(comm)` (parallel/trainer.py) every train-mode batch statistic
# is all-reduced over ``comm``'s ranks, and so are the backward's
# per-channel sums. Ranks hold equal shards.
_BN_SYNC = threading.local()


@contextlib.contextmanager
def bn_sync(comm):
    """Train-mode BatchNorm statistics over every rank of ``comm`` (a
    `parallel.mesh` communicator) inside; local outside."""
    prev = getattr(_BN_SYNC, "comm", None)
    _BN_SYNC.comm = comm if comm is not None and comm.size > 1 else None
    try:
        yield
    finally:
        _BN_SYNC.comm = prev


def _sync_comm():
    return getattr(_BN_SYNC, "comm", None)


def _global_stats(x: Tensor, comm):
    """`bn_batch_stats` over the ranks' shards: the two-pass biased
    variance of f32 and f64 (a sum, then the squared deviations from the
    global mean), the one-pass f32 moments of sub-f32 inputs."""
    dims = tuple(range(x.ndim - 1))
    n = float(x.numel() // x.shape[-1] * comm.size)
    if x.dtype in (torch.bfloat16, torch.float16):
        xf = x.float()
        m = comm.all_reduce(torch.stack([xf.sum(dim=dims),
                                         (xf * xf).sum(dim=dims)])) / n
        return m[0], torch.clamp_min(m[1] - m[0] * m[0], 0.0)
    mean = comm.all_reduce(x.sum(dim=dims)) / n
    d = x - mean
    var = comm.all_reduce((d * d).sum(dim=dims)) / n
    return mean, var


class _SyncStats(torch.autograd.Function):
    """(mean, var) of the global batch, differentiable: the backward sums
    every rank's gradient of the global statistics (each rank's loss
    reaches them) and hands each rank its x's share, d mean / dx = 1/n,
    d var / dx = 2 (x - mean) / n."""

    @staticmethod
    def forward(ctx, x, comm):
        mean, var = _global_stats(x.detach(), comm)
        ctx.save_for_backward(x, mean)
        ctx.comm = comm
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean = ctx.saved_tensors
        comm = ctx.comm
        g = comm.all_reduce(torch.stack([g_mean, g_var]).contiguous())
        n = float(x.numel() // x.shape[-1] * comm.size)
        xw = x.to(mean.dtype)
        dx = g[0] / n + g[1] * 2.0 * (xw - mean) / n
        return dx.to(x.dtype), None


def batch_stats(x: Tensor):
    """The train-mode batch statistics a BatchNorm normalizes with:
    `bn_batch_stats`, or the global ones inside `bn_sync`."""
    comm = _sync_comm()
    if comm is None:
        return bn_batch_stats(x)
    return _SyncStats.apply(x, comm)


# -- local response normalization ---------------------------------------------

def _lrn_default(x, *, k, n, alpha, beta):
    """x / (k + alpha * s)^beta, s the sum of squares over a window of
    2 * (n // 2) + 1 channels (channels last), zero-padded at the ends —
    JAX's `lax.reduce_window` (helpers.py :229). Not
    `F.local_response_norm`, which divides alpha by n and averages."""
    half = int(n) // 2
    C = x.shape[-1]
    sq = F.pad(x * x, (half, half))
    s = sq[..., 0:C]
    for j in range(1, 2 * half + 1):
        s = s + sq[..., j:j + C]
    return x / torch.pow(k + alpha * s, beta)


def lrn(x: Tensor, *, k=2.0, n=5.0, alpha=1e-4, beta=0.75) -> Tensor:
    impl = _HELPERS.get("lrn", _lrn_default)
    return impl(x, k=k, n=n, alpha=alpha, beta=beta)


# -- fused train-mode BatchNorm + activation + 2x2/s2 max-pool ----------------

def _bn_act_pool_default(x, gamma, beta, *, eps, activation):
    mean, var = batch_stats(x)
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


class _BnActPoolSync(torch.autograd.Function):
    """`_BnActPool` inside `bn_sync`: the forward normalizes with the
    global batch statistics, and the backward all-reduces the sums pass's
    per-channel (d beta, d gamma) before the dx pass, which divides by the
    local count: the global sums enter divided by the rank count. The
    returned d gamma and d beta stay the rank's own (the master's gradient
    all-reduce sums them)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, activation, sums, dx, comm):
        stats = _global_stats(x, comm)
        pooled, mean, var, inv = ck.bnap_forward_ref(
            x, gamma, beta, eps=eps, activation=activation, stats=stats)
        ctx.save_for_backward(x, gamma, beta, mean, inv)
        ctx.conf = (activation, sums, dx, comm)
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, gamma, beta, mean, inv = ctx.saved_tensors
        activation, sums, dx, comm = ctx.conf
        x = x.contiguous()
        g = g.contiguous()
        p = torch.stack([mean, inv, gamma.float(), beta.float()])
        dgamma, dbeta = sums(x, g, p, activation=activation)
        s = comm.all_reduce(torch.stack([dbeta, dgamma])) / comm.size
        dx_ = dx(x, g, p, s, activation=activation)
        return (dx_, dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
                None, None, None, None, None)


def _bnap_apply(x, gamma, beta, eps, activation, sums, dx):
    comm = _sync_comm()
    if comm is None:
        return _BnActPool.apply(x, gamma, beta, float(eps), activation,
                                sums, dx)
    return _BnActPoolSync.apply(x, gamma, beta, float(eps), activation,
                                sums, dx, comm)


def bn_act_pool_plain(x, gamma, beta, *, eps=1e-5, activation="relu"):
    """The composite with the PLAIN versions of both backward passes: what
    the kernels compute, in PyTorch ops, on any device."""
    return _bnap_apply(x, gamma, beta, eps, activation, ck.bnap_sums_ref,
                       ck.bnap_dx_ref)


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
    return _bnap_apply(x, gamma, beta, eps, activation, ck.bnap_sums,
                       ck.bnap_dx)


# -- full-sequence multi-head attention ----------------------------------------

def _attention_default(q: Tensor, k: Tensor, v: Tensor, *, causal=False,
                       scale=None) -> Tensor:
    """Dense attention, the JAX seam's default (helpers.py :246,
    parallel/ring.full_attention): the scale as a product, the dtype's min
    above the diagonal, softmax, autograd's gradient. Register it as
    "attention" to run the JAX package's default path."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    s = ck.attention_scores(q, k, causal, scale)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


class _Attention(torch.autograd.Function):
    """Forward: ``fwd(q, k, v)`` -> (o, lse), a forward kernel's wrapper
    (or its plain version) with its mask and scale bound, saving q, k, v,
    o and the rows' log-sum-exp. Backward: di = sum_d o * dO in f32 from o
    and dO upcast, one plain reduction (the JAX libraries compute it so in
    XLA outside their kernels: flash_attention.py :274,
    splash_attention_kernel.py :2285), then
    ``dkv`` and ``dq`` (q, k, v, dO, lse, di), the backward kernels'
    wrappers or their plain versions, in the libraries' order. Serves the
    flash kernels and the splash kernels alike."""

    @staticmethod
    def forward(ctx, q, k, v, fwd, dkv, dq):
        o, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.conf = (dkv, dq)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dkv, dq = ctx.conf
        do = do.contiguous()
        di = (o.float() * do.float()).sum(dim=-1).permute(0, 2, 1).contiguous()
        dk, dv = dkv(q, k, v, do, lse, di)
        return dq(q, k, v, do, lse, di), dk, dv, None, None, None


def _flash(q, k, v, causal, scale, fwd, dkv, dq):
    """The flash kernels (or their plain versions ``fwd``, ``dkv``,
    ``dq``) under `_Attention`, the scale applied to the scores."""
    kw = dict(causal=bool(causal), scale=float(scale) if scale is not None
              else 1.0 / math.sqrt(q.shape[-1]))
    return _Attention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            functools.partial(fwd, **kw),
                            functools.partial(dkv, **kw),
                            functools.partial(dq, **kw))


def _splash(q, k, v, causal, scale, fwd, dkv, dq):
    """`_splash_call` (JAX pallas_kernels.py :609): the splash kernels (or
    their plain versions) under `_Attention`, over the tables of
    MultiHeadMask([CausalMask | FullMask] * H) at block 128. The scale is
    folded into q in q's dtype first (:626: the scale itself rounded to
    that dtype, then the product), outside the Function, so autograd
    carries it into q's gradient; the batch is a dimension of the kernels
    (the library vmaps it, :627)."""
    B, L, H, D = q.shape
    s = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    if q.dtype != torch.float32:  # f32: a Python float is the same f32 scalar
        s = torch.full((), s, dtype=q.dtype, device=q.device)
    tables = splash_mask.splash_tables(L, H, bool(causal))
    return _Attention.apply((q * s).contiguous(), k.contiguous(),
                            v.contiguous(),
                            functools.partial(fwd, tables=tables),
                            functools.partial(dkv, tables=tables),
                            functools.partial(dq, tables=tables))


def splash_attention(q, k, v, *, causal=False, scale=None):
    """Attention through the three splash kernels (the plain versions on
    CPU tensors), at any L % 128 == 0; `attention` takes this route from
    SPLASH_MIN_LEN on."""
    return _splash(q, k, v, causal, scale, ck.splash_attention_fwd,
                   ck.splash_attention_bwd_dkv, ck.splash_attention_bwd_dq)


def splash_attention_plain(q, k, v, *, causal=False, scale=None):
    """The splash Function over the PLAIN versions of its three kernels,
    which work one chunk of query rows at a time and so never form the
    [L, L] scores."""
    return _splash(q, k, v, causal, scale, ck.splash_attention_fwd_ref,
                   ck.splash_attention_bwd_dkv_ref,
                   ck.splash_attention_bwd_dq_ref)


# The one rule that puts each attention kernel family on a path: splash from
# this length on (when the table's block divides L), flash below it. It is
# fixed, not autotuned: the JAX seam's per-shape probe (pallas_kernels.py
# :632) has no counterpart in the port, and a later change moves this
# threshold on the card's own timings of both kernels (chip_smoke.py times
# them at L = 32768).
SPLASH_MIN_LEN = 32768


def attention_route(L: int) -> str:
    """"splash" or "flash": the kernels `attention` runs at sequence length
    ``L``, a pure function of the shape."""
    return ("splash" if L >= SPLASH_MIN_LEN and L % splash_mask.BLOCK == 0
            else "flash")


def attention_plain(q, k, v, *, causal=False, scale=None):
    """The attention seam's Function over the PLAIN versions of the kernels
    its route takes (`attention_route`): what the kernels compute, in
    PyTorch ops, on any device."""
    if attention_route(q.shape[1]) == "splash":
        return splash_attention_plain(q, k, v, causal=causal, scale=scale)
    return _flash(q, k, v, causal, scale, ck.flash_attention_fwd_ref,
                  ck.flash_attention_bwd_dkv_ref, ck.flash_attention_bwd_dq_ref)


def attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
              scale=None) -> Tensor:
    """Multi-head attention seam (JAX helpers.py :253). q, k, v [B, L, H,
    D] with equal head counts (the layer repeats GQA's K/V heads first) ->
    [B, L, H, D]; ``scale`` defaults to 1/sqrt(D). Runs the kernels of
    `attention_route(L)` — splash from SPLASH_MIN_LEN, flash below: the
    forward, and the dK/dV and dQ backward under autograd — on CUDA
    tensors, their plain versions on CPU tensors, or the override the
    caller registered. q, k and v in f32 run the f32 kernels, in bf16 the
    bf16 kernels (the output, and the gradients, in their dtype); any other
    dtype raises TypeError, and on the card so does what the kernels do not
    take (a head dim outside ``cuda_kernels.FLASH_HEAD_DIMS``): no autotune,
    no silent fallback."""
    impl = _HELPERS.get("attention")
    if impl is not None:
        return impl(q, k, v, causal=causal, scale=scale)
    if attention_route(q.shape[1]) == "splash":
        return splash_attention(q, k, v, causal=causal, scale=scale)
    return _flash(q, k, v, causal, scale, ck.flash_attention_fwd,
                  ck.flash_attention_bwd_dkv, ck.flash_attention_bwd_dq)


# The caller's explicit way around every training kernel: register these to
# run each kernel's plain version instead, on any device.
PLAIN_OVERRIDES = {"conv2d_bias_act": conv2d_bias_act_plain,
                   "bn_act_pool": bn_act_pool_plain,
                   "attention": attention_plain}


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
