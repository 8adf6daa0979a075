"""Hand-written Hopper kernels of the port: wrappers, plain versions, counts.

Counterpart of deeplearning4j_tpu/ops/pallas_kernels.py. Each kernel is
CUDA C++ in ``ops/csrc/<name>.cu``, compiled for sm_90a by nvcc at first
use and bound with ctypes (``ops/_build.py``):

  - ``paged_decode_attention`` (paged-KV decode, fp32 and int8 pages);
  - ``conv2d_bias_act`` (NHWC conv + bias + activation, forward);
  - ``bnap_sums`` and ``bnap_dx`` (the two passes of the fused BN +
    activation + 2x2/s2 max-pool backward).

Rule of every wrapper here:

  - a tensor on the CPU runs the plain PyTorch version (the tests' path);
  - a tensor on a CUDA device launches the kernel, or raises: no fallback
    when the shape or dtype is unsupported or the build fails;
  - each launch adds one to ``LAUNCHES[<kernel>]`` — and nothing else
    does — so a run can show its main path went through the kernel.

The wrappers compute values only; the gradients of the conv and of the
BN+act+pool composite are `torch.autograd.Function`s in ``ops/helpers.py``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from . import activations
from .kvquant import dequantize_kv_rows

LAUNCHES = {"paged_decode_attention": 0, "conv2d_bias_act": 0,
            "bnap_sums": 0, "bnap_dx": 0}

# the kernel keeps G * Dh accumulators in registers: 128 threads x 16
_MAX_GROUP_DIM = 128 * 16
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int

# C entry points of each source: name -> argtypes (every one returns a
# cudaError_t as int, 0 on success)
_SIGNATURES = {
    "paged_decode_attention": {
        "dl4j_paged_decode_f32": [_PTR] * 6 + [_INT] * 6 + [_PTR],
        "dl4j_paged_decode_i8": [_PTR] * 8 + [_INT] * 6 + [_PTR]},
    "conv2d_bias_act": {
        "dl4j_conv2d_bias_act_f32": [_PTR] * 5 + [_INT] * 14 + [_PTR]},
    "bnap_sums": {
        "dl4j_bnap_sums_rows": [_INT] * 4,
        "dl4j_bnap_sums_f32": [_PTR] * 6 + [_INT] * 6 + [_PTR]},
    "bnap_dx": {
        "dl4j_bnap_dx_f32": [_PTR] * 5 + [_INT] * 5 + [_PTR]},
}

# activation codes of csrc/activations.cuh; "softmax" is not elementwise
# and has no code (the conv seam runs the identity epilogue, then softmax)
ACT_CODES = {"identity": 0, "linear": 0, "relu": 1, "tanh": 2, "sigmoid": 3,
             "leakyrelu": 4, "elu": 5, "selu": 6, "softplus": 7,
             "softsign": 8, "hardtanh": 9, "hardsigmoid": 10, "cube": 11,
             "rationaltanh": 12, "rectifiedtanh": 13, "gelu": 14,
             "swish": 15}
# activations whose derivative the BN+act+pool backward recomputes
# (JAX pallas_kernels.py `_BNAP_ACTS` :239)
BNAP_ACTS = ("relu", "identity", "linear", "tanh", "sigmoid")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def paged_decode_attention_ref(q, k_pages, v_pages, table, pos, *,
                               k_scales=None, v_scales=None):
    """Plain version: port of `_xla_paged_reference` (pallas_kernels.py
    :927). Gathers the row's whole logical cache through the table
    (dequantizing int8 pages to the query dtype first), then the grouped
    contraction with an f32 softmax and per-row causal depths — the read
    side of the attention layer's gather body."""
    B, T, H, Dh = q.shape
    block, Hkv = k_pages.shape[1], k_pages.shape[2]
    L = table.shape[1] * block
    dt = q.dtype
    tl = table.long()
    if k_scales is not None:
        kc = dequantize_kv_rows(k_pages[tl], k_scales[tl], dt).reshape(
            B, L, Hkv, Dh)
        vc = dequantize_kv_rows(v_pages[tl], v_scales[tl], dt).reshape(
            B, L, Hkv, Dh)
    else:
        kc = k_pages[tl].reshape(B, L, Hkv, Dh)
        vc = v_pages[tl].reshape(B, L, Hkv, Dh)
    qg = q.reshape(B, T, Hkv, H // Hkv, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc) / math.sqrt(Dh)
    ar = torch.arange(L, device=q.device)
    valid = ar[None, None, :] <= (pos.long()[:, None, None]
                                  + torch.arange(T, device=q.device)[None, :,
                                                                     None])
    s = torch.where(valid[:, None, None], s.float(),
                    torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(dt)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, vc).reshape(B, T, H, Dh)


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _lib(name: str):
    lib = _build.load(name)
    if not getattr(lib, "_dl4j_bound", False):
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _INT
        lib.dl4j_cuda_error_string.argtypes = [_INT]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
        lib._dl4j_bound = True
    return lib


def _raise_on(rc: int, lib, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.dl4j_cuda_error_string(rc).decode()} (cudaError {rc})")


def _stream(dev) -> ctypes.c_void_p:
    return _PTR(torch.cuda.current_stream(dev).cuda_stream)


def _device_of(name: str, tensors) -> torch.device:
    """The one device of ``tensors``; raises for mixed devices and for
    device types the kernels do not run on."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one device "
                         f"(the first is on {dev})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def paged_decode_attention(q, k_pages, v_pages, table, pos, *,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None):
    """Paged decode attention. q [B, 1, H, Dh] f32; pages [P, block, Hkv,
    Dh] f32, or int8 with f32 scales [P, block, Hkv]; table [B, nb]
    int32; pos [B] int32 -> [B, 1, H, Dh] f32.

    CPU tensors run :func:`paged_decode_attention_ref`. CUDA tensors
    launch the kernel on the current stream, or raise."""
    quantized = k_scales is not None
    if quantized != (v_scales is not None):
        raise ValueError("k_scales and v_scales come together")
    tensors = [q, k_pages, v_pages, table, pos] + (
        [k_scales, v_scales] if quantized else [])
    dev = _device_of("paged_decode_attention", tensors)
    if dev.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, table, pos,
                                          k_scales=k_scales,
                                          v_scales=v_scales)
    if q.dim() != 4 or k_pages.dim() != 4 or table.dim() != 2:
        raise ValueError("paged_decode_attention: q [B,1,H,Dh], pages "
                         "[P,block,Hkv,Dh], table [B,nb]")
    B, T, H, Dh = q.shape
    P, block, Hkv, _ = k_pages.shape
    nb = table.shape[1]
    if T != 1:
        raise ValueError(f"paged_decode_attention: one query token per "
                         f"row, got T={T}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"paged_decode_attention: H={H} is not a multiple "
                         f"of Hkv={Hkv}")
    G = H // Hkv
    if G * Dh > _MAX_GROUP_DIM or B > 65535 or nb < 1:
        raise ValueError(f"paged_decode_attention: unsupported shape "
                         f"G*Dh={G * Dh}, B={B}, nb={nb}")
    smem = 4 * (G * Dh + 2 * block * Dh + G * block + 3 * G)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_decode_attention: block={block}, Dh={Dh} "
                         f"need {smem} B of shared memory")
    page_dtype = torch.int8 if quantized else torch.float32
    _check("q", q, torch.float32, (B, 1, H, Dh))
    _check("k_pages", k_pages, page_dtype, (P, block, Hkv, Dh))
    _check("v_pages", v_pages, page_dtype, (P, block, Hkv, Dh))
    _check("table", table, torch.int32, (B, nb))
    _check("pos", pos, torch.int32, (B,))
    if quantized:
        _check("k_scales", k_scales, torch.float32, (P, block, Hkv))
        _check("v_scales", v_scales, torch.float32, (P, block, Hkv))
    lib = _lib("paged_decode_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        dims = (B, H, Hkv, Dh, block, nb)
        if quantized:
            rc = lib.dl4j_paged_decode_i8(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scales.data_ptr(), v_scales.data_ptr(), table.data_ptr(),
                pos.data_ptr(), out.data_ptr(), *dims, stream)
        else:
            rc = lib.dl4j_paged_decode_f32(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                table.data_ptr(), pos.data_ptr(), out.data_ptr(), *dims,
                stream)
    _raise_on(rc, lib, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    return out


# -- fused conv2d + bias + activation ------------------------------------------

def conv_geometry(h: int, w: int, kh: int, kw: int, stride,
                  padding, dilation=(1, 1)):
    """(oh, ow, ((top, bottom), (left, right))) of an NHWC conv — port of
    `_conv_geometry` (pallas_kernels.py :72), with the kernel extent
    dilated as `lax.conv_general_dilated` dilates it. ``padding`` is
    "SAME", "VALID" or explicit ((top, bottom), (left, right))."""
    sh, sw = stride
    ekh = (kh - 1) * dilation[0] + 1
    ekw = (kw - 1) * dilation[1] + 1
    if padding == "SAME":
        oh = -(-h // sh)
        ow = -(-w // sw)
        pad_h = max((oh - 1) * sh + ekh - h, 0)
        pad_w = max((ow - 1) * sw + ekw - w, 0)
        pads = ((pad_h // 2, pad_h - pad_h // 2),
                (pad_w // 2, pad_w - pad_w // 2))
    elif padding == "VALID":
        pads = ((0, 0), (0, 0))
        oh = (h - ekh) // sh + 1
        ow = (w - ekw) // sw + 1
    else:
        pads = tuple((int(p[0]), int(p[1])) for p in padding)
        oh = (h + pads[0][0] + pads[0][1] - ekh) // sh + 1
        ow = (w + pads[1][0] + pads[1][1] - ekw) // sw + 1
    return oh, ow, pads


def conv2d_ref(x, w, *, stride=(1, 1), padding="SAME", dilation=(1, 1)):
    """Plain NHWC x HWIO conv: the pads of `conv_geometry` applied with
    `F.pad`, then `F.conv2d` on NCHW/OIHW views (the layout PyTorch's
    conv takes); the result is NHWC again."""
    kh, kw = w.shape[0], w.shape[1]
    _, _, pads = conv_geometry(x.shape[1], x.shape[2], kh, kw, stride,
                               padding, dilation)
    xp = F.pad(x, (0, 0, pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    y = F.conv2d(xp.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=tuple(stride), dilation=tuple(dilation))
    return y.permute(0, 2, 3, 1)


def conv2d_bias_act_ref(x, w, b, *, stride=(1, 1), padding="SAME",
                        activation="identity", want_pre=False):
    """Plain version of the conv kernel: act(conv2d_ref(x, w) + b), the
    XLA default of the JAX seam (helpers.py :64); with ``want_pre``, the
    pair (act(z), z) of z = conv2d_ref(x, w) + b."""
    z = conv2d_ref(x, w, stride=stride, padding=padding) + b
    y = activations.get(activation)(z)
    return (y, z) if want_pre else y


def conv2d_bias_act(x, w, b, *, stride=(1, 1), padding="SAME",
                    activation="identity", want_pre=False):
    """Fused NHWC conv + bias + activation. x [B, H, W, C] f32, w [KH, KW,
    C, OC] f32 (HWIO), b [OC] f32 -> [B, OH, OW, OC] f32; stride (sh, sw);
    padding "SAME", "VALID" or ((top, bottom), (left, right)). With
    ``want_pre`` it returns (out, pre), ``pre`` the pre-activation conv +
    bias, which the same launch writes.

    CPU tensors run :func:`conv2d_bias_act_ref`. CUDA tensors launch the
    kernel on the current stream, or raise."""
    dev = _device_of("conv2d_bias_act", [x, w, b])
    if dev.type == "cpu":
        return conv2d_bias_act_ref(x, w, b, stride=stride, padding=padding,
                                   activation=activation, want_pre=want_pre)
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("conv2d_bias_act: x [B,H,W,C], w [KH,KW,C,OC]")
    act = ACT_CODES.get(str(activation).lower())
    if act is None:
        raise ValueError(f"conv2d_bias_act: activation {activation!r} has no "
                         "kernel epilogue")
    B, H, W, C = x.shape
    KH, KW, _, OC = w.shape
    _check("x", x, torch.float32, (B, H, W, C))
    _check("w", w, torch.float32, (KH, KW, C, OC))
    _check("b", b, torch.float32, (OC,))
    sh, sw = (int(s) for s in stride)
    oh, ow, pads = conv_geometry(H, W, KH, KW, (sh, sw), padding)
    if oh < 1 or ow < 1 or sh < 1 or sw < 1 or min(min(p) for p in pads) < 0:
        raise ValueError(f"conv2d_bias_act: invalid geometry: input {H}x{W}, "
                         f"kernel {KH}x{KW}, stride {stride}, pads {pads}")
    lib = _lib("conv2d_bias_act")
    out = torch.empty((B, oh, ow, OC), dtype=torch.float32, device=dev)
    pre = torch.empty_like(out) if want_pre else None
    with torch.cuda.device(dev):
        rc = lib.dl4j_conv2d_bias_act_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if pre is None else pre.data_ptr(),
            B, H, W, C, KH, KW, OC, oh, ow, sh, sw, pads[0][0], pads[1][0],
            act, _stream(dev))
    _raise_on(rc, lib, "conv2d_bias_act")
    LAUNCHES["conv2d_bias_act"] += 1
    return (out, pre) if want_pre else out


# -- fused BN + activation + 2x2/s2 max-pool backward -------------------------

def bnap_forward_ref(x, gamma, beta, *, eps, activation):
    """The composite's forward (JAX `fwd_chain`, pallas_kernels.py :332):
    batch stats, normalize, activation, 2x2/s2 max. Returns (pooled, mean,
    var, inv) with f32 stats. x [B, H, W, C], H and W even."""
    mean = torch.mean(x, dim=(0, 1, 2))
    var = torch.var(x, dim=(0, 1, 2), unbiased=False)
    inv = torch.rsqrt(var + eps)
    a = activations.get(activation)((x - mean) * inv * gamma + beta)
    B, H, W, C = x.shape
    pooled = a.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))
    return pooled, mean, var, inv


def _bnap_dact(z, activation):
    if activation == "relu":
        return (z > 0).to(z.dtype)
    if activation == "tanh":
        return 1.0 - torch.tanh(z) ** 2
    if activation == "sigmoid":
        return torch.sigmoid(z) * (1.0 - torch.sigmoid(z))
    return torch.ones_like(z)


def _bnap_recompute_ref(x, g, p, activation):
    """Port of `_bnap_recompute` (pallas_kernels.py :250) on the 6-D view
    [B, H/2, 2, W/2, 2, C]: x_hat and the routed gradient g_z, with the
    pooled gradient split evenly among tied window maxima."""
    B, H, W, C = x.shape
    xv = x.reshape(B, H // 2, 2, W // 2, 2, C)
    xh = (xv - p[0]) * p[1]
    z = xh * p[2] + p[3]
    a = activations.get(activation)(z)
    m = a.amax(dim=(2, 4), keepdim=True)
    eq = (a == m).to(x.dtype)
    cnt = eq.sum(dim=(2, 4), keepdim=True)
    ga = eq * (g.reshape(B, H // 2, 1, W // 2, 1, C) / cnt)
    return xh, ga * _bnap_dact(z, activation)


def bnap_sums_ref(x, g, p, *, activation):
    """Plain version of the sums pass: (d gamma, d beta) = (sum g_z *
    x_hat, sum g_z) per channel."""
    xh, gz = _bnap_recompute_ref(x, g, p, activation)
    dims = (0, 1, 2, 3, 4)
    return (gz * xh).sum(dim=dims), gz.sum(dim=dims)


def bnap_dx_ref(x, g, p, s, *, activation):
    """Plain version of the dx pass: inv * gamma * (g_z - s[0] / n - x_hat
    * s[1] / n), n = B * H * W, s = (d beta, d gamma)."""
    B, H, W, C = x.shape
    n = B * H * W
    xh, gz = _bnap_recompute_ref(x, g, p, activation)
    dx = p[1] * p[2] * (gz - s[0] / n - xh * (s[1] / n))
    return dx.reshape(B, H, W, C)


def _bnap_checks(name, x, g, p, activation):
    if x.dim() != 4:
        raise ValueError(f"{name}: x [B,H,W,C]")
    B, H, W, C = x.shape
    if H % 2 or W % 2 or H < 2 or W < 2:
        raise ValueError(f"{name}: H and W must be even, got {H}x{W}")
    if activation not in BNAP_ACTS:
        raise ValueError(f"{name}: activation {activation!r} is not one of "
                         f"{BNAP_ACTS}")
    _check("x", x, torch.float32, (B, H, W, C))
    _check("g", g, torch.float32, (B, H // 2, W // 2, C))
    _check("p", p, torch.float32, (4, C))
    return B, H, W, C


def bnap_sums(x, g, p, *, activation):
    """Pass 1 of the fused backward. x [B, H, W, C] f32, g [B, H/2, W/2, C]
    f32 (the pooled output's gradient), p [4, C] f32 = (mean, inv, gamma,
    beta) -> (d gamma [C], d beta [C]) f32, the same bits on every run.

    CPU tensors run :func:`bnap_sums_ref`. CUDA tensors launch the kernel
    on the current stream, or raise."""
    dev = _device_of("bnap_sums", [x, g, p])
    if dev.type == "cpu":
        return bnap_sums_ref(x, g, p, activation=activation)
    B, H, W, C = _bnap_checks("bnap_sums", x, g, p, activation)
    lib = _lib("bnap_sums")
    rows = lib.dl4j_bnap_sums_rows(B, H, W, C)
    part = torch.empty((rows, 2, C), dtype=torch.float32, device=dev)
    dg = torch.empty((C,), dtype=torch.float32, device=dev)
    db = torch.empty((C,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.dl4j_bnap_sums_f32(
            x.data_ptr(), g.data_ptr(), p.data_ptr(), part.data_ptr(),
            dg.data_ptr(), db.data_ptr(), B, H, W, C, ACT_CODES[activation],
            rows, _stream(dev))
    _raise_on(rc, lib, "bnap_sums")
    LAUNCHES["bnap_sums"] += 1
    return dg, db


def bnap_dx(x, g, p, s, *, activation):
    """Pass 2 of the fused backward: inputs as :func:`bnap_sums`, plus s
    [2, C] f32 = (d beta, d gamma) -> dx [B, H, W, C] f32.

    CPU tensors run :func:`bnap_dx_ref`. CUDA tensors launch the kernel on
    the current stream, or raise."""
    dev = _device_of("bnap_dx", [x, g, p, s])
    if dev.type == "cpu":
        return bnap_dx_ref(x, g, p, s, activation=activation)
    B, H, W, C = _bnap_checks("bnap_dx", x, g, p, activation)
    _check("s", s, torch.float32, (2, C))
    lib = _lib("bnap_dx")
    dx = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = lib.dl4j_bnap_dx_f32(
            x.data_ptr(), g.data_ptr(), p.data_ptr(), s.data_ptr(),
            dx.data_ptr(), B, H, W, C, ACT_CODES[activation], _stream(dev))
    _raise_on(rc, lib, "bnap_dx")
    LAUNCHES["bnap_dx"] += 1
    return dx
