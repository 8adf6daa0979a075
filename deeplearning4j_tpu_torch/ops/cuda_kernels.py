"""Hand-written Hopper kernels of the port: wrappers, plain versions, counts.

Counterpart of deeplearning4j_tpu/ops/pallas_kernels.py. Each kernel is
CUDA C++ in ``ops/csrc/<name>.cu``, compiled for sm_90a by nvcc at first
use and bound with ctypes (``ops/_build.py``):

  - ``paged_decode_attention`` (paged-KV decode, fp32 and int8 pages);
  - ``conv2d_bias_act`` (NHWC conv + bias + activation, forward);
  - ``bnap_sums`` and ``bnap_dx`` (the two passes of the fused BN +
    activation + 2x2/s2 max-pool backward);
  - ``flash_attention_fwd``, ``flash_attention_bwd_dkv`` and
    ``flash_attention_bwd_dq`` (full-sequence attention and its gradients;
    the last two share ``flash_attention_bwd.cu``);
  - ``splash_attention_fwd``, ``splash_attention_bwd_dkv`` and
    ``splash_attention_bwd_dq`` (the same function walked through the
    block tables of ``ops/splash_mask.py``, for long sequences; the last
    two share ``splash_attention_bwd.cu``).

The six attention wrappers take f32 or bf16 (`KERNEL_DTYPES`), and so do
the conv and the two BN+act+pool backward wrappers; each launches the kernel of that dtype, and a bf16 launch counts under the
kernel's name with ``_bf16`` appended. Their plain versions at bf16 make
the roundings of the TPU kernel or library each kernel replaces
(`_bf16_round` and its callers; `conv2d_bias_act_ref`; the BN+act+pool
plain versions compute in f32 and compare ties in x's dtype).

Rule of every wrapper here:

  - a tensor on the CPU runs the plain PyTorch version (the tests' path);
  - a tensor on a CUDA device launches the kernel, or raises: no fallback
    when the shape or dtype is unsupported or the build fails;
  - each launch adds one to ``LAUNCHES[<kernel>]`` — and nothing else
    does — so a run can show its main path went through the kernel.

The wrappers compute values only; the gradients of the conv, of the
BN+act+pool composite and of attention are `torch.autograd.Function`s in
``ops/helpers.py``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from . import activations
from . import splash_mask
from .kvquant import dequantize_kv_rows

LAUNCHES = {"paged_decode_attention": 0, "conv2d_bias_act": 0,
            "bnap_sums": 0, "bnap_dx": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
            "splash_attention_fwd": 0, "splash_attention_bwd_dkv": 0,
            "splash_attention_bwd_dq": 0}
# the bf16 kernels count apart: "<kernel>_bf16"
LAUNCHES.update({f"{name}_bf16": 0 for name in (
    "conv2d_bias_act", "bnap_sums", "bnap_dx",
    "flash_attention_fwd", "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq", "splash_attention_fwd",
    "splash_attention_bwd_dkv", "splash_attention_bwd_dq")})
# the bf16 bnap_sums and bnap_dx launches (counted in LAUNCHES) by the
# route they took (`bnap_bf16_route`)
BNAP_BF16_ROUTES = {"ring": 0, "lanes": 0}

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)
# the paged kernel's lanes hold at most 8 head dims each (32 lanes)
_PAGED_MAX_DH = 256
# paged decode: blocks of the page walk to aim for, two per SM of an H100
_PAGED_TARGET_BLOCKS = 2 * 132
_PAGED_WARPS = 4  # warps (work items at a time) of one page-walk block
# bnap_sums: threads of a block, and blocks to aim for: two resident per SM
# of an H100 (the kernel's launch bounds), so one wave of equal blocks
_BNAP_THREADS = 256
_BNAP_TARGET_BLOCKS = 2 * 132
_H100_SMS = 132  # the bf16 ring route's persistent grid: kRingBlocksPerSm each

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float

# C entry points of each source: name -> argtypes (every one returns a
# cudaError_t as int, 0 on success)
_SIGNATURES = {
    "paged_decode_attention": {
        "dl4j_paged_decode_f32": [_PTR] * 7 + [_INT] * 7 + [_PTR],
        "dl4j_paged_decode_i8": [_PTR] * 9 + [_INT] * 7 + [_PTR],
        "dl4j_paged_decode_attrs": [_INT] * 4 + [_PTR]},
    "conv2d_bias_act": {
        "dl4j_conv2d_bias_act_f32": [_PTR] * 5 + [_INT] * 14 + [_PTR],
        "dl4j_conv2d_bias_act_bf16": [_PTR] * 5 + [_INT] * 14 + [_PTR],
        "dl4j_conv2d_bias_act_attrs": [_INT, _INT, _PTR],
        "dl4j_conv2d_bias_act_bf16_attrs": [_INT, _INT, _PTR],
        "dl4j_conv2d_bias_act_bf16_route": [_PTR] * 2 + [_INT] * 13,
        "dl4j_conv_bf16_wgmma_roles": [_PTR]},
    "bnap_sums": {
        "dl4j_bnap_sums_f32": [_PTR] * 7 + [_INT] * 14 + [_PTR],
        "dl4j_bnap_sums_bf16": [_PTR] * 7 + [_INT] * 14 + [_PTR],
        "dl4j_bnap_sums_attrs": [_INT, _INT, _PTR],
        "dl4j_bnap_sums_bf16_attrs": [_INT, _INT, _PTR],
        "dl4j_bnap_sums_bf16_ring": [_PTR] * 7 + [_INT] * 10 + [_PTR],
        "dl4j_bnap_sums_bf16_ring_attrs": [_INT, _PTR]},
    "bnap_dx": {
        "dl4j_bnap_dx_f32": [_PTR] * 5 + [_INT] * 5 + [_PTR],
        "dl4j_bnap_dx_bf16": [_PTR] * 5 + [_INT] * 5 + [_PTR],
        "dl4j_bnap_dx_bf16_attrs": [_PTR],
        "dl4j_bnap_dx_bf16_ring": [_PTR] * 5 + [_INT] * 8 + [_PTR],
        "dl4j_bnap_dx_bf16_ring_attrs": [_INT, _PTR]},
    "flash_attention_fwd": {
        "dl4j_flash_fwd_f32": [_PTR] * 5 + [_INT] * 5 + [_FLOAT, _PTR],
        "dl4j_flash_fwd_bf16": [_PTR] * 5 + [_INT] * 5 + [_FLOAT, _PTR],
        "dl4j_flash_fwd_attrs": [_INT, _INT, _PTR],
        "dl4j_flash_fwd_bf16_attrs": [_INT, _INT, _PTR],
        "dl4j_attn_fwd_bf16_roles": [_PTR]},
    "flash_attention_bwd": {
        "dl4j_flash_bwd_dkv_f32": [_PTR] * 8 + [_INT] * 5 + [_FLOAT, _PTR],
        "dl4j_flash_bwd_dq_f32": [_PTR] * 7 + [_INT] * 5 + [_FLOAT, _PTR],
        "dl4j_flash_bwd_dkv_bf16": [_PTR] * 8 + [_INT] * 5 + [_FLOAT, _PTR],
        "dl4j_flash_bwd_dq_bf16": [_PTR] * 7 + [_INT] * 5 + [_FLOAT, _PTR],
        "dl4j_flash_bwd_dkv_attrs": [_INT, _INT, _PTR],
        "dl4j_flash_bwd_dq_attrs": [_INT, _INT, _PTR],
        "dl4j_flash_bwd_dkv_bf16_attrs": [_INT, _INT, _PTR],
        "dl4j_flash_bwd_dq_bf16_attrs": [_INT, _INT, _PTR],
        "dl4j_attn_dkv_bf16_roles": [_PTR],
        "dl4j_attn_dq_bf16_roles": [_PTR]},
    "splash_attention_fwd": {
        "dl4j_splash_fwd_f32": [_PTR] * 8 + [_INT] * 6 + [_PTR],
        "dl4j_splash_fwd_bf16": [_PTR] * 8 + [_INT] * 6 + [_PTR],
        "dl4j_splash_fwd_attrs": [_INT, _PTR],
        "dl4j_splash_fwd_bf16_attrs": [_INT, _PTR]},
    "splash_attention_bwd": {
        "dl4j_splash_bwd_dkv_f32": [_PTR] * 11 + [_INT] * 6 + [_PTR],
        "dl4j_splash_bwd_dq_f32": [_PTR] * 10 + [_INT] * 6 + [_PTR],
        "dl4j_splash_bwd_dkv_bf16": [_PTR] * 11 + [_INT] * 6 + [_PTR],
        "dl4j_splash_bwd_dq_bf16": [_PTR] * 10 + [_INT] * 6 + [_PTR],
        "dl4j_splash_bwd_dq_attrs": [_INT, _PTR],
        "dl4j_splash_bwd_dkv_attrs": [_INT, _PTR],
        "dl4j_splash_bwd_dq_bf16_attrs": [_INT, _PTR],
        "dl4j_splash_bwd_dkv_bf16_attrs": [_INT, _PTR]},
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
    for k in BNAP_BF16_ROUTES:
        BNAP_BF16_ROUTES[k] = 0


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


# the dtypes the f32/bf16 kernel pairs take for their data tensors (q, k,
# v, dO of attention; x, w, b of the conv; x, g of the BN+act+pool
# backward), one dtype for all of a call's; each has its own kernel (lse,
# di, p and s are always f32)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _kernel_dtype(name, *tensors) -> torch.dtype:
    """The one dtype of ``tensors``: f32 or bf16, else TypeError."""
    dt = tensors[0].dtype
    if dt not in KERNEL_DTYPES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{name}: dtypes {[t.dtype for t in tensors]}; the "
                        f"kernels take them all in one of {KERNEL_DTYPES}")
    return dt


def _check_aligned(name, *tensors):
    """Raise unless every tensor starts on 16 bytes: kernels that copy
    16-byte chunks (every attention kernel: the forwards, the dK/dV and the
    dQ kernels) need it. Fresh allocations always do; a view with an odd
    storage offset may not."""
    for i, t in enumerate(tensors):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: input {i} does not start on 16 bytes "
                             f"(storage offset {t.storage_offset()})")


def _launch_key(name: str, dtype: torch.dtype) -> str:
    return name if dtype == torch.float32 else f"{name}_bf16"


def _entry(dtype: torch.dtype) -> str:
    """The suffix of the C entry point for ``dtype``."""
    return "f32" if dtype == torch.float32 else "bf16"


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


def _paged_splits(B: int, Hkv: int, nb: int) -> int:
    """S, the page-walk blocks per (row, kv-head) of the paged kernel: about
    two blocks per SM over the B * Hkv pairs, at most one per page. A fixed
    formula of the shapes (pos lives on the device), not a timed search: the
    same shapes give the same S, so the same bits."""
    return max(1, min(nb, -(-_PAGED_TARGET_BLOCKS // max(B * Hkv, 1))))


def _paged_split_pages(nb: int, S: int) -> int:
    """P, the pages of one split: split s walks the live pages among [s P,
    (s + 1) P)."""
    return -(-nb // S)


def paged_decode_attention(q, k_pages, v_pages, table, pos, *,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None):
    """Paged decode attention. q [B, 1, H, Dh] f32; pages [P, block, Hkv,
    Dh] f32, or int8 with f32 scales [P, block, Hkv]; table [B, nb]
    int32; pos [B] int32 -> [B, 1, H, Dh] f32.

    CPU tensors run :func:`paged_decode_attention_ref`. CUDA tensors
    launch the kernels on the current stream (the page walk over
    `_paged_splits` splits, then the combine when there is more than one),
    or raise."""
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
    if Dh > _PAGED_MAX_DH or B > 65535 or Hkv > 65535 or nb < 1:
        raise ValueError(f"paged_decode_attention: unsupported shape "
                         f"Dh={Dh}, B={B}, Hkv={Hkv}, nb={nb}")
    # one page-walk block holds (acc, m, l) of its G C work items, C =
    # max(1, 4 // G) page classes per query head
    smem = 4 * G * max(1, _PAGED_WARPS // G) * (Dh + 2)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_decode_attention: G={G}, Dh={Dh} need "
                         f"{smem} B of shared memory")
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
    S = _paged_splits(B, Hkv, nb)
    out = torch.empty_like(q)
    # the splits' (acc, m, l); never read when S == 1
    ws = torch.empty((B, Hkv, S, G, Dh + 2) if S > 1 else (1,),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        dims = (B, H, Hkv, Dh, block, nb, S)
        if quantized:
            rc = lib.dl4j_paged_decode_i8(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scales.data_ptr(), v_scales.data_ptr(), table.data_ptr(),
                pos.data_ptr(), out.data_ptr(), ws.data_ptr(), *dims, stream)
        else:
            rc = lib.dl4j_paged_decode_f32(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                ws.data_ptr(), *dims, stream)
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
    pair (act(z), z) of z = conv2d_ref(x, w) + b.

    At bf16, the JAX kernel's roundings (pallas_kernels.py :102, :116,
    :158): the conv of the upcast operands in f32 (products of two bf16
    values are exact in f32, so only the order of the sums differs from
    the kernel's), the bias and the activation in f32, and one rounding
    to bf16 at the end, of act(z) and of z."""
    if x.dtype == torch.bfloat16:
        out = conv2d_bias_act_ref(x.float(), w.float(), b.float(),
                                  stride=stride, padding=padding,
                                  activation=activation, want_pre=want_pre)
        if want_pre:
            return tuple(t.to(x.dtype) for t in out)
        return out.to(x.dtype)
    z = conv2d_ref(x, w, stride=stride, padding=padding) + b
    y = activations.get(activation)(z)
    return (y, z) if want_pre else y



def conv2d_bias_act(x, w, b, *, stride=(1, 1), padding="SAME",
                    activation="identity", want_pre=False):
    """Fused NHWC conv + bias + activation. x [B, H, W, C], w [KH, KW, C,
    OC] (HWIO), b [OC], all f32 or all bf16 -> [B, OH, OW, OC] in their
    dtype; stride (sh, sw); padding "SAME", "VALID" or ((top, bottom),
    (left, right)). With ``want_pre`` it returns (out, pre), ``pre`` the
    pre-activation conv + bias, which the same launch writes. The bf16
    kernel accumulates in f32 and rounds once, at the store.

    CPU tensors run :func:`conv2d_bias_act_ref`. CUDA tensors launch the
    kernel of their dtype on the current stream, or raise."""
    dev = _device_of("conv2d_bias_act", [x, w, b])
    if dev.type == "cpu":
        return conv2d_bias_act_ref(x, w, b, stride=stride, padding=padding,
                                   activation=activation, want_pre=want_pre)
    dt = _kernel_dtype("conv2d_bias_act", x, w, b)
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("conv2d_bias_act: x [B,H,W,C], w [KH,KW,C,OC]")
    act = ACT_CODES.get(str(activation).lower())
    if act is None:
        raise ValueError(f"conv2d_bias_act: activation {activation!r} has no "
                         "kernel epilogue")
    B, H, W, C = x.shape
    KH, KW, _, OC = w.shape
    _check("x", x, dt, (B, H, W, C))
    _check("w", w, dt, (KH, KW, C, OC))
    _check("b", b, dt, (OC,))
    sh, sw = (int(s) for s in stride)
    oh, ow, pads = conv_geometry(H, W, KH, KW, (sh, sw), padding)
    if oh < 1 or ow < 1 or sh < 1 or sw < 1 or min(min(p) for p in pads) < 0:
        raise ValueError(f"conv2d_bias_act: invalid geometry: input {H}x{W}, "
                         f"kernel {KH}x{KW}, stride {stride}, pads {pads}")
    lib = _lib("conv2d_bias_act")
    out = torch.empty((B, oh, ow, OC), dtype=dt, device=dev)
    pre = torch.empty_like(out) if want_pre else None
    with torch.cuda.device(dev):
        rc = getattr(lib, f"dl4j_conv2d_bias_act_{_entry(dt)}")(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if pre is None else pre.data_ptr(),
            B, H, W, C, KH, KW, OC, oh, ow, sh, sw, pads[0][0], pads[1][0],
            act, _stream(dev))
    _raise_on(rc, lib, "conv2d_bias_act")
    LAUNCHES[_launch_key("conv2d_bias_act", dt)] += 1
    return (out, pre) if want_pre else out


# -- fused BN + activation + 2x2/s2 max-pool backward -------------------------

def bn_batch_stats(x):
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


def _wide(t):
    """t at f32, or at f64 when it is f64: the dtype the BN+act+pool
    composite computes in (JAX `fwd_chain` :335 casts to f32)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def bnap_forward_ref(x, gamma, beta, *, eps, activation, stats=None):
    """The composite's forward (JAX `fwd_chain`, pallas_kernels.py :332):
    f32 batch stats (`bn_batch_stats`, or ``stats`` = (mean, var) given:
    a data-parallel rank's global ones), z normalized in f32 from x and
    the f32 gamma and beta, act(z) rounded to x's dtype, then the 2x2/s2
    max. Returns (pooled in x's dtype, mean, var, inv in f32; f64 for an
    f64 x). x [B, H, W, C], H and W even."""
    mean, var = bn_batch_stats(x) if stats is None else stats
    inv = torch.rsqrt(var + eps)
    z = (_wide(x) - mean) * inv * _wide(gamma) + _wide(beta)
    a = activations.get(activation)(z).to(x.dtype)
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
    [B, H/2, 2, W/2, 2, C], in f32 from x and g upcast (f64 stays f64):
    x_hat and the routed gradient g_z (both f32), with the pooled gradient split evenly
    among the window's maxima, compared after the activation is rounded to
    x's dtype (:272-275), as the forward's pool compared them."""
    B, H, W, C = x.shape
    xv = _wide(x).reshape(B, H // 2, 2, W // 2, 2, C)
    xh = (xv - p[0]) * p[1]
    z = xh * p[2] + p[3]
    a = activations.get(activation)(z).to(x.dtype).to(z.dtype)
    m = a.amax(dim=(2, 4), keepdim=True)
    eq = (a == m).to(z.dtype)
    cnt = eq.sum(dim=(2, 4), keepdim=True)
    ga = eq * (_wide(g).reshape(B, H // 2, 1, W // 2, 1, C) / cnt)
    return xh, ga * _bnap_dact(z, activation)


def bnap_sums_ref(x, g, p, *, activation):
    """Plain version of the sums pass: (d gamma, d beta) = (sum g_z *
    x_hat, sum g_z) per channel, f32."""
    xh, gz = _bnap_recompute_ref(x, g, p, activation)
    dims = (0, 1, 2, 3, 4)
    return (gz * xh).sum(dim=dims), gz.sum(dim=dims)


def bnap_dx_ref(x, g, p, s, *, activation):
    """Plain version of the dx pass: inv * gamma * (g_z - s[0] / n - x_hat
    * s[1] / n), n = B * H * W, s = (d beta, d gamma), in f32 and written
    in x's dtype (:309)."""
    B, H, W, C = x.shape
    n = B * H * W
    xh, gz = _bnap_recompute_ref(x, g, p, activation)
    dx = p[1] * p[2] * (gz - s[0] / n - xh * (s[1] / n))
    return dx.reshape(B, H, W, C).to(x.dtype)


def _bnap_checks(name, x, g, p, activation):
    if x.dim() != 4:
        raise ValueError(f"{name}: x [B,H,W,C]")
    B, H, W, C = x.shape
    if H % 2 or W % 2 or H < 2 or W < 2:
        raise ValueError(f"{name}: H and W must be even, got {H}x{W}")
    if activation not in BNAP_ACTS:
        raise ValueError(f"{name}: activation {activation!r} is not one of "
                         f"{BNAP_ACTS}")
    dt = _kernel_dtype(name, x, g)
    _check("x", x, dt, (B, H, W, C))
    _check("g", g, dt, (B, H // 2, W // 2, C))
    _check("p", p, torch.float32, (4, C))
    return B, H, W, C


def bnap_sums_plan(B, H, W, C, vec):
    """The sums kernel's partition (csrc/bnap_sums.cu), a fixed formula of
    the shape: ``vec`` channels per lane, blocks of ``cl`` lanes across the
    channels by ``pl`` thread rows; thread row ty walks pooled columns
    ty % pwn, + pwn, ... of rows ty // pwn, + rl, ... of its block's run of
    ``rpb`` pooled rows; ``rblocks`` row blocks (about _BNAP_TARGET_BLOCKS
    blocks in all), whose partial rows are added by groups of ``group``,
    then the ``ngroups`` group rows."""
    lanes = C // vec
    cl = min(lanes, 64)
    pl = _BNAP_THREADS // cl
    pwn = min(pl, W // 2)
    cblocks = -(-lanes // cl)
    R = B * (H // 2)
    rpb = max(1, -(-R * cblocks // _BNAP_TARGET_BLOCKS))
    rblocks = -(-R // rpb)
    group = math.isqrt(rblocks - 1) + 1  # ceil(sqrt(rblocks))
    return {"vec": vec, "cl": cl, "pl": pl, "pwn": pwn, "rl": pl // pwn,
            "cblocks": cblocks, "rpb": rpb, "rblocks": rblocks,
            "group": group, "ngroups": -(-rblocks // group)}


@functools.lru_cache(maxsize=None)
def bnap_bf16_route_limits() -> dict:
    """The constants of the bf16 BN+act+pool ring route, read from the
    ``kRing`` constants of ``csrc/bnap_common.cuh``, their one table:
    {"kRingC": 8, "kRingMaxC": 1024, "kRingAlign": 16, "kRingMaxElems":
    2^31 - 1, "kRingRowCap": 2048, "kRingConsumers": 128, ...}."""
    import pathlib
    import re
    text = (pathlib.Path(__file__).with_name("csrc")
            / "bnap_common.cuh").read_text()
    return {name: int(value) for name, value in re.findall(
        r"constexpr (?:int|long long) (kRing\w+) = (\d+)(?:LL)?;", text)}


def bnap_bf16_route(B: int, H: int, W: int, C: int, x_ptr: int = 0,
                    g_ptr: int = 0, dx_ptr: int = 0) -> str:
    """The bf16 kernel pair that ``bnap_sums`` and ``bnap_dx`` launch for
    x [B, H, W, C] at address ``x_ptr``, g at ``g_ptr`` and dx at
    ``dx_ptr``, by the rule of ``csrc/bnap_common.cuh`` `ring_route` over
    `bnap_bf16_route_limits`: "ring" (the persistent kernels fed by bulk
    copies through an mbarrier ring, 16-byte lanes of 8 channels) when C
    is a multiple of 8 and at most 1024, x, g and dx start on 16 bytes,
    and B H W C is at most 2^31 - 1; "lanes" (a thread per pooled position
    and channel for dx, lanes of 4 or 1 channels for the sums) otherwise.
    A fixed rule on the shape, not a timed choice."""
    lim = bnap_bf16_route_limits()
    ring = (C % lim["kRingC"] == 0 and lim["kRingC"] <= C <= lim["kRingMaxC"]
            and B * H * W * C <= lim["kRingMaxElems"]
            and all(p % lim["kRingAlign"] == 0
                    for p in (x_ptr, g_ptr, dx_ptr)))
    return "ring" if ring else "lanes"


def bnap_bf16_plan(B: int, H: int, W: int, C: int) -> dict:
    """The bf16 ring kernels' walk (csrc/bnap_common.cuh), a fixed formula
    of the shape: items of ``wn`` pooled columns of one pooled row
    (``nchunks`` a row; ``items`` in all), a persistent grid of ``grid``
    blocks, kRingBlocksPerSm per SM of an H100 (or one an item), block b
    walking items b, b + grid, ...: ``per_block`` items, or one fewer,
    so that every SM's three blocks take the same number of items within
    one; ``lanes`` lanes of kRingLaneC = 8 channels, ``slots`` consumers a
    lane; the sums' partial rows added by groups of ``group``, then the
    ``ngroups`` group rows."""
    lim = bnap_bf16_route_limits()
    W2 = W // 2
    wn = min(W2, lim["kRingRowCap"] // (2 * C))
    nchunks = -(-W2 // wn)
    items = B * (H // 2) * nchunks
    grid = min(items, lim["kRingBlocksPerSm"] * _H100_SMS)
    per_block = -(-items // grid)
    group = math.isqrt(grid - 1) + 1  # ceil(sqrt(grid))
    lanes = C // lim["kRingLaneC"]
    return {"wn": wn, "nchunks": nchunks, "items": items,
            "per_block": per_block, "grid": grid, "group": group,
            "ngroups": -(-grid // group), "lanes": lanes,
            "slots": lim["kRingConsumers"] // lanes}


# the sums kernel's ticket counters, by (device, stream): each is back at 0
# when the launch that used it ends, and launches on one stream run in turn
_BNAP_TICKETS = {}


def _bnap_tickets(dev, n):
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    t = _BNAP_TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _BNAP_TICKETS[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                             device=dev)
    return t


def bnap_sums(x, g, p, *, activation):
    """Pass 1 of the fused backward. x [B, H, W, C] and g [B, H/2, W/2, C]
    (the pooled output's gradient), both f32 or both bf16, p [4, C] f32 =
    (mean, inv, gamma, beta) -> (d gamma [C], d beta [C]) f32, the same
    bits on every run. At bf16 the window's maxima and ties are those of
    the activation rounded to bf16, as the forward's pool saw them.

    CPU tensors run :func:`bnap_sums_ref`. CUDA tensors launch the kernel
    of their dtype on the current stream, or raise; at bf16, the kernel of
    the shape's route (`bnap_bf16_route`)."""
    dev = _device_of("bnap_sums", [x, g, p])
    if dev.type == "cpu":
        return bnap_sums_ref(x, g, p, activation=activation)
    B, H, W, C = _bnap_checks("bnap_sums", x, g, p, activation)
    dt = x.dtype
    if dt == torch.bfloat16 and bnap_bf16_route(
            B, H, W, C, x.data_ptr(), g.data_ptr()) == "ring":
        return _bnap_sums_ring(x, g, p, activation, dev)
    # four channels a lane: one 16-byte load of f32, one 8-byte load of
    # bf16 (p is f32 either way)
    vec = 4 if (C % 4 == 0 and p.data_ptr() % 16 == 0
                and all(t.data_ptr() % (4 * t.element_size()) == 0
                        for t in (x, g))) else 1
    plan = bnap_sums_plan(B, H, W, C, vec)
    lib = _lib("bnap_sums")
    part = torch.empty((plan["rblocks"] + plan["ngroups"], 2, C),
                       dtype=torch.float32, device=dev)
    dg = torch.empty((C,), dtype=torch.float32, device=dev)
    db = torch.empty((C,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        ticket = _bnap_tickets(dev, plan["cblocks"] * (plan["ngroups"] + 1))
        rc = getattr(lib, f"dl4j_bnap_sums_{_entry(dt)}")(
            x.data_ptr(), g.data_ptr(), p.data_ptr(), part.data_ptr(),
            dg.data_ptr(), db.data_ptr(), ticket.data_ptr(), B, H, W, C,
            ACT_CODES[activation], *(plan[k] for k in (
                "vec", "cl", "pl", "pwn", "rl", "rpb", "rblocks", "group",
                "ngroups")), _stream(dev))
    _raise_on(rc, lib, "bnap_sums")
    LAUNCHES[_launch_key("bnap_sums", dt)] += 1
    if dt == torch.bfloat16:
        BNAP_BF16_ROUTES["lanes"] += 1
    return dg, db


def _bnap_sums_ring(x, g, p, activation, dev):
    B, H, W, C = x.shape
    plan = bnap_bf16_plan(B, H, W, C)
    lib = _lib("bnap_sums")
    part = torch.empty((plan["grid"] + plan["ngroups"], 2, C),
                       dtype=torch.float32, device=dev)
    dg = torch.empty((C,), dtype=torch.float32, device=dev)
    db = torch.empty((C,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        ticket = _bnap_tickets(dev, plan["ngroups"] + 1)
        rc = lib.dl4j_bnap_sums_bf16_ring(
            x.data_ptr(), g.data_ptr(), p.data_ptr(), part.data_ptr(),
            dg.data_ptr(), db.data_ptr(), ticket.data_ptr(), B, H, W, C,
            ACT_CODES[activation], *(plan[k] for k in (
                "wn", "nchunks", "grid", "group", "ngroups")), _stream(dev))
    _raise_on(rc, lib, "bnap_sums")
    LAUNCHES["bnap_sums_bf16"] += 1
    BNAP_BF16_ROUTES["ring"] += 1
    return dg, db


def bnap_bf16_ring_attrs() -> dict:
    """{"sums", "dx"}: attrs (as `_kernel_attrs`; smem_bytes is the static
    and dynamic shared memory) of the two bf16 ring kernels at relu,
    AlexNet's activation. Needs the card."""
    relu = ACT_CODES["relu"]
    return {"sums": _kernel_attrs("bnap_sums", "dl4j_bnap_sums_bf16_ring_attrs",
                                  relu),
            "dx": _kernel_attrs("bnap_dx", "dl4j_bnap_dx_bf16_ring_attrs",
                                relu)}


def bnap_sums_attrs(dtype=torch.float32) -> dict:
    """{"vec4", "vec1"}: attrs (as `_kernel_attrs`; smem_bytes is the
    static shared memory) of the sums kernel's two lane widths at relu,
    AlexNet's activation, for x and g in ``dtype``. Needs the card."""
    fn = f"dl4j_bnap_sums_{'' if dtype == torch.float32 else 'bf16_'}attrs"
    return {f"vec{v}": _kernel_attrs("bnap_sums", fn, v, ACT_CODES["relu"])
            for v in (4, 1)}


def bnap_dx_bf16_attrs() -> dict:
    """Attrs (as `bnap_sums_attrs`) of the bf16 dx kernel. Needs the
    card."""
    return _kernel_attrs("bnap_dx", "dl4j_bnap_dx_bf16_attrs")


def bnap_dx(x, g, p, s, *, activation):
    """Pass 2 of the fused backward: inputs as :func:`bnap_sums`, plus s
    [2, C] f32 = (d beta, d gamma) -> dx [B, H, W, C] in x's dtype,
    computed in f32 and rounded once at the store.

    CPU tensors run :func:`bnap_dx_ref`. CUDA tensors launch the kernel of
    their dtype on the current stream, or raise; at bf16, the kernel of the
    shape's route (`bnap_bf16_route`)."""
    dev = _device_of("bnap_dx", [x, g, p, s])
    if dev.type == "cpu":
        return bnap_dx_ref(x, g, p, s, activation=activation)
    B, H, W, C = _bnap_checks("bnap_dx", x, g, p, activation)
    _check("s", s, torch.float32, (2, C))
    lib = _lib("bnap_dx")
    dx = torch.empty_like(x)
    ring = x.dtype == torch.bfloat16 and bnap_bf16_route(
        B, H, W, C, x.data_ptr(), g.data_ptr(), dx.data_ptr()) == "ring"
    with torch.cuda.device(dev):
        if ring:
            plan = bnap_bf16_plan(B, H, W, C)
            rc = lib.dl4j_bnap_dx_bf16_ring(
                x.data_ptr(), g.data_ptr(), p.data_ptr(), s.data_ptr(),
                dx.data_ptr(), B, H, W, C, ACT_CODES[activation],
                plan["wn"], plan["nchunks"], plan["grid"], _stream(dev))
        else:
            rc = getattr(lib, f"dl4j_bnap_dx_{_entry(x.dtype)}")(
                x.data_ptr(), g.data_ptr(), p.data_ptr(), s.data_ptr(),
                dx.data_ptr(), B, H, W, C, ACT_CODES[activation],
                _stream(dev))
    _raise_on(rc, lib, "bnap_dx")
    LAUNCHES[_launch_key("bnap_dx", x.dtype)] += 1
    if x.dtype == torch.bfloat16:
        BNAP_BF16_ROUTES["ring" if ring else "lanes"] += 1
    return dx


# -- flash attention: forward, dK/dV backward, dQ backward -------------------

# head dims the kernels are instantiated for (64 x D tiles in shared memory)
FLASH_HEAD_DIMS = (16, 32, 64, 128)
def _bf16_round(x):
    """x (f32) rounded to bf16 and back: the libraries' ``astype(bf16)`` of
    p or ds before a product whose operands are bf16."""
    return x.to(torch.bfloat16).float()


def attention_scores(q, k, causal, scale):
    """s = q k^T * scale [B, H, L, L] of q, k [B, L, H, D], with the dense
    default's fill of the dtype's min above the diagonal when ``causal``
    (parallel/ring.full_attention)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        L = q.shape[1]
        mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
    return s


def flash_attention_fwd_ref(q, k, v, *, causal, scale):
    """Plain version of the forward kernel: the dense default attention (the
    same ops, so the same values) and the rows' log-sum-exp. q, k, v [B, L,
    H, D] -> (o [B, L, H, D], lse [B, H, L]).

    At bf16, the library's roundings (flash_attention.py :471): the scores
    and softmax statistics in f32 from the bf16 operands, p = exp(s - m)
    rounded to bf16 before p v, o summed in f32 and divided by the f32 row
    sum, then written in bf16; lse f32."""
    if q.dtype == torch.bfloat16:
        v32 = v.float()
        s = attention_scores(q.float(), k.float(), causal, scale)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bkhd->bhqd", _bf16_round(p), v32) / l
        return (o.permute(0, 2, 1, 3).to(q.dtype).contiguous(),
                (m + torch.log(l)).squeeze(-1))
    s = attention_scores(q, k, causal, scale)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return o, torch.logsumexp(s, dim=-1)


def _probs_and_ds(q, k, v, do, lse, di, causal, scale):
    s = attention_scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    return p, p * (dp - di[..., None])


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, di, *, causal, scale):
    """Plain version of the dK/dV kernel: p = exp(s - lse), ds = p (dO v^T -
    di); (dk, dv) = (scale ds^T q, p^T dO). At bf16, as the library rounds
    (flash_attention.py :900, :918): all in f32 from the bf16 operands, ds
    scaled, then p and ds rounded to bf16 before the products; dk and dv
    written in bf16."""
    if q.dtype == torch.bfloat16:
        q32, do32 = q.float(), do.float()
        p, ds = _probs_and_ds(q32, k.float(), v.float(), do32, lse, di,
                              causal, scale)
        return (torch.einsum("bhqk,bqhd->bkhd", _bf16_round(ds * scale),
                             q32).to(q.dtype),
                torch.einsum("bhqk,bqhd->bkhd", _bf16_round(p),
                             do32).to(q.dtype))
    p, ds = _probs_and_ds(q, k, v, do, lse, di, causal, scale)
    return (torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, do))


def flash_attention_bwd_dq_ref(q, k, v, do, lse, di, *, causal, scale):
    """Plain version of the dQ kernel: dq = scale ds k. At bf16 the scaled
    ds is rounded to bf16 before ds k (flash_attention.py :1258), dq summed
    in f32 and written in bf16."""
    if q.dtype == torch.bfloat16:
        k32 = k.float()
        _, ds = _probs_and_ds(q.float(), k32, v.float(), do.float(), lse, di,
                              causal, scale)
        return torch.einsum("bhqk,bkhd->bqhd", _bf16_round(ds * scale),
                            k32).to(q.dtype)
    _, ds = _probs_and_ds(q, k, v, do, lse, di, causal, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale


def _flash_checks(name, q, k, v):
    """Shapes, dtypes and contiguity the kernels take: q, k, v [B, L, H, D]
    in one of KERNEL_DTYPES, with D in FLASH_HEAD_DIMS."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q, k, v [B, L, H, D]")
    B, L, H, D = q.shape
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} is not one of "
                         f"{FLASH_HEAD_DIMS}")
    if min(B, L, H) < 1 or max(B, H) > 65535:
        raise ValueError(f"{name}: unsupported shape {tuple(q.shape)}")
    dt = _kernel_dtype(name, q, k, v)
    for n, t in (("q", q), ("k", k), ("v", v)):
        _check(n, t, dt, (B, L, H, D))
    return B, L, H, D


def flash_attention_fwd(q, k, v, *, causal, scale):
    """Attention forward. q, k, v [B, L, H, D], all f32 or all bf16 ->
    (o [B, L, H, D] in their dtype, lse [B, H, L] f32), D in
    FLASH_HEAD_DIMS, any L >= 1. Other dtypes raise TypeError.

    CPU tensors run :func:`flash_attention_fwd_ref`. CUDA tensors launch
    the kernel of their dtype on the current stream, or raise."""
    dev = _device_of("flash_attention_fwd", [q, k, v])
    dt = _kernel_dtype("flash_attention_fwd", q, k, v)
    if dev.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal=causal, scale=scale)
    B, L, H, D = _flash_checks("flash_attention_fwd", q, k, v)
    _check_aligned("flash_attention_fwd", q, k, v)
    lib = _lib("flash_attention_fwd")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, f"dl4j_flash_fwd_{_entry(dt)}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, L, H, D, int(bool(causal)), float(scale),
            _stream(dev))
    _raise_on(rc, lib, "flash_attention_fwd")
    LAUNCHES[_launch_key("flash_attention_fwd", dt)] += 1
    return o, lse


def _kernel_attrs(lib_name: str, fn: str, *args) -> dict:
    """{"registers", "local_bytes", "smem_bytes"} of one kernel as the
    loaded binary has it: registers per thread, local memory per thread
    (spills and stack), dynamic shared memory per block."""
    out = (ctypes.c_int * 3)()
    lib = _lib(lib_name)
    _raise_on(getattr(lib, fn)(*args, out), lib, fn)
    return dict(zip(("registers", "local_bytes", "smem_bytes"), list(out)))


def attention_tc_attrs(D: int) -> dict:
    """{kernel: attrs} (as `_kernel_attrs`) of the attention kernels on the
    tensor cores at head dim D: the flash forward, dK/dV and dQ (causal and
    full), the splash forward, dK/dV and dQ. Needs the card."""
    return {"flash_fwd_causal": _kernel_attrs(
                "flash_attention_fwd", "dl4j_flash_fwd_attrs", D, 1),
            "flash_fwd_full": _kernel_attrs(
                "flash_attention_fwd", "dl4j_flash_fwd_attrs", D, 0),
            "splash_fwd": _kernel_attrs(
                "splash_attention_fwd", "dl4j_splash_fwd_attrs", D),
            "flash_bwd_dkv_causal": _kernel_attrs(
                "flash_attention_bwd", "dl4j_flash_bwd_dkv_attrs", D, 1),
            "flash_bwd_dkv_full": _kernel_attrs(
                "flash_attention_bwd", "dl4j_flash_bwd_dkv_attrs", D, 0),
            "flash_bwd_dq_causal": _kernel_attrs(
                "flash_attention_bwd", "dl4j_flash_bwd_dq_attrs", D, 1),
            "flash_bwd_dq_full": _kernel_attrs(
                "flash_attention_bwd", "dl4j_flash_bwd_dq_attrs", D, 0),
            "splash_bwd_dkv": _kernel_attrs(
                "splash_attention_bwd", "dl4j_splash_bwd_dkv_attrs", D),
            "splash_bwd_dq": _kernel_attrs(
                "splash_attention_bwd", "dl4j_splash_bwd_dq_attrs", D)}


def attention_bf16_attrs(D: int) -> dict:
    """{kernel: attrs} (as `_kernel_attrs`) of the bf16 attention kernels at
    head dim D, named as in `attention_tc_attrs`. Needs the card."""
    fl, sp = "flash_attention", "splash_attention"
    return {"flash_fwd_causal": _kernel_attrs(
                f"{fl}_fwd", "dl4j_flash_fwd_bf16_attrs", D, 1),
            "flash_fwd_full": _kernel_attrs(
                f"{fl}_fwd", "dl4j_flash_fwd_bf16_attrs", D, 0),
            "splash_fwd": _kernel_attrs(
                f"{sp}_fwd", "dl4j_splash_fwd_bf16_attrs", D),
            "flash_bwd_dkv_causal": _kernel_attrs(
                f"{fl}_bwd", "dl4j_flash_bwd_dkv_bf16_attrs", D, 1),
            "flash_bwd_dkv_full": _kernel_attrs(
                f"{fl}_bwd", "dl4j_flash_bwd_dkv_bf16_attrs", D, 0),
            "flash_bwd_dq_causal": _kernel_attrs(
                f"{fl}_bwd", "dl4j_flash_bwd_dq_bf16_attrs", D, 1),
            "flash_bwd_dq_full": _kernel_attrs(
                f"{fl}_bwd", "dl4j_flash_bwd_dq_bf16_attrs", D, 0),
            "splash_bwd_dkv": _kernel_attrs(
                f"{sp}_bwd", "dl4j_splash_bwd_dkv_bf16_attrs", D),
            "splash_bwd_dq": _kernel_attrs(
                f"{sp}_bwd", "dl4j_splash_bwd_dq_bf16_attrs", D)}


def attention_bf16_fwd_roles() -> dict:
    """The warp specialisation of the bf16 forward kernels (flash and
    splash share the core, ops/csrc/attn_fwd_bf16.cuh): threads per block,
    registers of the producer warpgroup and of each consumer warpgroup
    after setmaxnreg, the ring's stages, keys per K/V tile, query rows per
    block. Needs the card."""
    out = (ctypes.c_int * 6)()
    lib = _lib("flash_attention_fwd")
    _raise_on(lib.dl4j_attn_fwd_bf16_roles(out), lib,
              "dl4j_attn_fwd_bf16_roles")
    return dict(zip(("threads", "producer_registers", "consumer_registers",
                     "stages", "keys_per_tile", "rows_per_block"), list(out)))


def attention_bf16_dkv_roles() -> dict:
    """The shape of the bf16 dK/dV kernels (flash and splash share the
    core, ops/csrc/attn_dkv_bf16.cuh): threads per block (two
    warpgroups), the ring's stages, keys per block, query rows per q and
    dO tile. Needs the card."""
    out = (ctypes.c_int * 4)()
    lib = _lib("flash_attention_bwd")
    _raise_on(lib.dl4j_attn_dkv_bf16_roles(out), lib,
              "dl4j_attn_dkv_bf16_roles")
    return dict(zip(("threads", "stages", "keys_per_block",
                     "rows_per_tile"), list(out)))


def attention_bf16_dq_roles() -> dict:
    """The shape of the bf16 dQ kernels (flash and splash share the core,
    ops/csrc/attn_dq_bf16.cuh): threads per block (two warpgroups), the
    ring's stages, query rows per block, keys per k and v tile. Needs the
    card."""
    out = (ctypes.c_int * 4)()
    lib = _lib("flash_attention_bwd")
    _raise_on(lib.dl4j_attn_dq_bf16_roles(out), lib,
              "dl4j_attn_dq_bf16_roles")
    return dict(zip(("threads", "stages", "rows_per_block",
                     "keys_per_tile"), list(out)))


def paged_decode_attrs(G: int, Dh: int) -> dict:
    """{kernel: attrs} (as `_kernel_attrs`) of the paged decode kernels that
    G query heads per kv-head at head dim Dh launch: the page walk over
    fp32 and over int8 pages, and the combine. Needs the card."""
    return {name: _kernel_attrs("paged_decode_attention",
                                "dl4j_paged_decode_attrs", quant, combine, G,
                                Dh)
            for name, quant, combine in (("walk_fp32", 0, 0),
                                         ("walk_int8", 1, 0),
                                         ("combine", 0, 1))}


def conv2d_bias_act_attrs(C: int, OC: int, dtype=torch.float32) -> dict:
    """Attrs (as `_kernel_attrs`) of the conv kernel variant that C input
    and OC output channels launch in ``dtype`` (16-byte aligned x and w; at
    bf16 the kernel that `conv_bf16_route` gives a 1 x 1 conv). Needs the
    card."""
    fn = ("dl4j_conv2d_bias_act_attrs" if dtype == torch.float32
          else "dl4j_conv2d_bias_act_bf16_attrs")
    return _kernel_attrs("conv2d_bias_act", fn, C, OC)


@functools.lru_cache(maxsize=None)
def conv_bf16_route_limits() -> dict:
    """The limits of the bf16 conv route, read from the ``kRoute``
    constants of ``csrc/conv_bf16.cuh``, their one table: {"kRouteC": 64,
    "kRouteOC": 8, "kRouteAlign": 16, "kRouteMaxM": 2^31 - 129, ...}."""
    import pathlib
    import re
    text = (pathlib.Path(__file__).with_name("csrc")
            / "conv_bf16.cuh").read_text()
    out = {}
    for name, expr in re.findall(
            r"constexpr (?:int|long long) (kRoute\w+) = ([^;]+);", text):
        m = re.fullmatch(r"(-?\d+)(?:LL)?(?:\s*-\s*(\d+))?", expr.strip())
        out[name] = int(m.group(1)) - int(m.group(2) or 0)
    return out


def conv_bf16_route(B: int, H: int, W: int, C: int, KH: int, KW: int,
                    OC: int, stride=(1, 1), padding="SAME", x_ptr: int = 0,
                    w_ptr: int = 0) -> str:
    """The bf16 conv kernel that a launch of ``conv2d_bias_act`` (x [B, H,
    W, C] at address ``x_ptr``, w [KH, KW, C, OC] at ``w_ptr``) takes, by
    the rule of ``csrc/conv_bf16.cuh`` `wgmma_route` over the limits of
    `conv_bf16_route_limits`: "wgmma" (the implicit GEMM on wgmma, A by TMA
    im2col) when C is a multiple of 64 and OC of 8, x and w are 16-byte
    aligned, M = B * OH * OW is at most 2^31 - 129, and TMA's im2col mode
    encodes the geometry (strides at most 8, the bounding box's corners
    -pad and pad - (k - 1) in [-128, 127], KH and KW at most 256);
    "mma_sync" (the bf16 mma.sync kernel) otherwise. The CPU tests read the
    rule here; `conv_bf16_route_on_card` asks the built library."""
    lim = conv_bf16_route_limits()
    sh, sw = (int(v) for v in stride)
    oh, ow, pads = conv_geometry(H, W, KH, KW, (sh, sw), padding)
    corners = (-pads[1][0], -pads[0][0],
               (ow - 1) * sw - pads[1][0] - (W - 1),
               (oh - 1) * sh - pads[0][0] - (H - 1))
    wgmma = (C % lim["kRouteC"] == 0 and OC % lim["kRouteOC"] == 0
             and x_ptr % lim["kRouteAlign"] == 0
             and w_ptr % lim["kRouteAlign"] == 0
             and B * oh * ow <= lim["kRouteMaxM"]
             and max(sh, sw) <= lim["kRouteMaxStride"]
             and max(KH, KW) <= lim["kRouteMaxTap"]
             and all(lim["kRouteCornerLo"] <= c <= lim["kRouteCornerHi"]
                     for c in corners))
    return "wgmma" if wgmma else "mma_sync"


def conv_bf16_route_on_card(B: int, H: int, W: int, C: int, KH: int,
                            KW: int, OC: int, stride=(1, 1),
                            padding="SAME", x_ptr: int = 0,
                            w_ptr: int = 0) -> str:
    """`conv_bf16_route` as the built kernel library decides it, the rule
    that runs. Needs the card."""
    sh, sw = (int(v) for v in stride)
    oh, ow, pads = conv_geometry(H, W, KH, KW, (sh, sw), padding)
    lib = _lib("conv2d_bias_act")
    wgmma = lib.dl4j_conv2d_bias_act_bf16_route(
        x_ptr or None, w_ptr or None, B, H, W, C, KH, KW, OC, oh, ow, sh,
        sw, pads[0][0], pads[1][0])
    return "wgmma" if wgmma else "mma_sync"


def conv_bf16_wgmma_roles() -> dict:
    """The warp specialisation of the bf16 wgmma conv kernel
    (csrc/conv_bf16.cuh): threads per block, registers of the producer
    warpgroup and of each consumer warpgroup after setmaxnreg, the ring's
    stages, the output tile's rows and columns, K per slice. Needs the
    card."""
    out = (ctypes.c_int * 7)()
    lib = _lib("conv2d_bias_act")
    _raise_on(lib.dl4j_conv_bf16_wgmma_roles(out), lib,
              "dl4j_conv_bf16_wgmma_roles")
    return dict(zip(("threads", "producer_registers", "consumer_registers",
                     "stages", "tile_rows", "tile_cols", "k_per_slice"),
                    list(out)))


def _bwd_checks(name, q, k, v, do, lse, di, checks=_flash_checks):
    """``checks`` on q, k, v, then do [B, L, H, D] in q's dtype, lse and di
    [B, H, L] f32, all contiguous."""
    B, L, H, D = checks(name, q, k, v)
    for n, t, shape, dt in (("do", do, (B, L, H, D), q.dtype),
                            ("lse", lse, (B, H, L), torch.float32),
                            ("di", di, (B, H, L), torch.float32)):
        _check(n, t, dt, shape)
    return B, L, H, D


def flash_attention_bwd_dkv(q, k, v, do, lse, di, *, causal, scale):
    """dK/dV backward. q, k, v, do [B, L, H, D], all f32 or all bf16, lse
    and di = sum_d o * do [B, H, L] f32 -> (dk, dv) [B, L, H, D] in q's
    dtype, the same bits on every launch.

    CPU tensors run :func:`flash_attention_bwd_dkv_ref`. CUDA tensors
    launch the kernel of their dtype on the current stream, or raise."""
    dev = _device_of("flash_attention_bwd_dkv", [q, k, v, do, lse, di])
    dt = _kernel_dtype("flash_attention_bwd_dkv", q, k, v, do)
    if dev.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, di,
                                           causal=causal, scale=scale)
    B, L, H, D = _bwd_checks("flash_attention_bwd_dkv", q, k, v, do, lse, di)
    _check_aligned("flash_attention_bwd_dkv", q, k, v, do)
    lib = _lib("flash_attention_bwd")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(dev):
        rc = getattr(lib, f"dl4j_flash_bwd_dkv_{_entry(dt)}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, L,
            H, D, int(bool(causal)), float(scale), _stream(dev))
    _raise_on(rc, lib, "flash_attention_bwd_dkv")
    LAUNCHES[_launch_key("flash_attention_bwd_dkv", dt)] += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, di, *, causal, scale):
    """dQ backward: inputs as :func:`flash_attention_bwd_dkv` -> dq [B, L,
    H, D] in q's dtype, the same bits on every launch.

    CPU tensors run :func:`flash_attention_bwd_dq_ref`. CUDA tensors launch
    the kernel of their dtype on the current stream, or raise."""
    dev = _device_of("flash_attention_bwd_dq", [q, k, v, do, lse, di])
    dt = _kernel_dtype("flash_attention_bwd_dq", q, k, v, do)
    if dev.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, di,
                                          causal=causal, scale=scale)
    B, L, H, D = _bwd_checks("flash_attention_bwd_dq", q, k, v, do, lse, di)
    _check_aligned("flash_attention_bwd_dq", q, k, v, do)
    lib = _lib("flash_attention_bwd")
    dq = torch.empty_like(q)
    with torch.cuda.device(dev):
        rc = getattr(lib, f"dl4j_flash_bwd_dq_{_entry(dt)}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), B, L, H, D,
            int(bool(causal)), float(scale), _stream(dev))
    _raise_on(rc, lib, "flash_attention_bwd_dq")
    LAUNCHES[_launch_key("flash_attention_bwd_dq", dt)] += 1
    return dq


# -- splash attention: the same three passes, walked through block tables ----

SPLASH_HEAD_DIMS = FLASH_HEAD_DIMS
# score elements [B, H, chunk, L] one chunk of the plain versions holds: at
# [1, 32768, 4, 128] a chunk is 1024 query rows, 512 MiB of f32 scores
SPLASH_PLAIN_CHUNK_ELEMS = 1 << 27


def _splash_q_chunk(B, L, H, q_chunk=None) -> int:
    """Query rows per chunk of the plain versions: ``q_chunk`` or what fits
    SPLASH_PLAIN_CHUNK_ELEMS, a multiple of the table's block."""
    if q_chunk is None:
        q_chunk = SPLASH_PLAIN_CHUNK_ELEMS // max(B * H * L, 1)
    blk = splash_mask.BLOCK
    return min(L, max(blk, int(q_chunk) // blk * blk))


def _splash_masked_scores(q, k, grid, r0, r1):
    """Scores q[:, r0:r1] k^T [B, H, r1 - r0, L] with the block table's mask
    applied: kind-0 and the masked part of kind-1 blocks at
    DEFAULT_MASK_VALUE. ``grid`` [R, q blocks, kv blocks] int8 on q's
    device holds the kinds the kernel's block list encodes."""
    blk = splash_mask.BLOCK
    L = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r1], k)
    kinds = grid[:, r0 // blk:r1 // blk].repeat_interleave(
        blk, dim=1).repeat_interleave(blk, dim=2)[None]  # [1, R, C, L]
    qpos = torch.arange(r0, r1, device=q.device)
    causal = qpos[:, None] >= torch.arange(L, device=q.device)[None, :]
    keep = (kinds == 2) | ((kinds == 1) & causal)
    return torch.where(keep, s, splash_mask.DEFAULT_MASK_VALUE)


def splash_attention_fwd_ref(q, k, v, tables, *, q_chunk=None):
    """Plain version of the splash forward kernel: the masked scores of one
    chunk of query rows at a time (the forward block list, rebuilt as block
    kinds), their softmax against v and their log-sum-exp. q is pre-scaled.
    Never forms more than one chunk of scores, so it runs at L = 32768 on
    the card. q, k, v [B, L, H, D] -> (o [B, L, H, D], lse [B, H, L]).

    At bf16 the library computes in f32 throughout, p and v included
    (splash_attention_kernel.py :819): the f32 function of the upcast
    operands, o written in bf16, lse f32."""
    if q.dtype == torch.bfloat16:
        o, lse = splash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                          tables, q_chunk=q_chunk)
        return o.to(q.dtype), lse
    B, L, H, _ = q.shape
    grid = tables.grid_on(q.device, "fwd")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=q.dtype, device=q.device)
    step = _splash_q_chunk(B, L, H, q_chunk)
    for r0 in range(0, L, step):
        r1 = min(L, r0 + step)
        s = _splash_masked_scores(q, k, grid, r0, r1)
        o[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        lse[:, :, r0:r1] = torch.logsumexp(s, dim=-1)
    return o, lse


def _splash_probs_and_ds(q, k, v, do, lse, di, grid, r0, r1):
    s = _splash_masked_scores(q, k, grid, r0, r1)
    p = torch.exp(s - lse[:, :, r0:r1, None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do[:, r0:r1], v)
    return p, p * (dp - di[:, :, r0:r1, None])


def _plain_operands(q, k, v, do):
    """(q, k, v, do, rnd, dtype): bf16 operands upcast to f32 with ``rnd``
    the bf16 rounding of p and ds before a product, as the library rounds
    them; any other dtype as given, with ``rnd`` the identity."""
    dt = q.dtype
    if dt == torch.bfloat16:
        return q.float(), k.float(), v.float(), do.float(), _bf16_round, dt
    return q, k, v, do, (lambda x: x), dt


def splash_attention_bwd_dkv_ref(q, k, v, do, lse, di, tables, *,
                                 q_chunk=None):
    """Plain version of the dK/dV kernel, over the dK/dV block list: p =
    exp(s - lse), ds = p (dO v^T - di); dk = sum over query chunks of ds^T
    q, dv of p^T dO (no scale: q is pre-scaled). At bf16, in f32 from the
    bf16 operands with p and ds rounded to bf16 before the products
    (splash_attention_kernel.py :1788, :1804); dk and dv written in bf16."""
    q, k, v, do, rnd, dt = _plain_operands(q, k, v, do)
    B, L, H, _ = q.shape
    grid = tables.grid_on(q.device, "dkv")
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    step = _splash_q_chunk(B, L, H, q_chunk)
    for r0 in range(0, L, step):
        r1 = min(L, r0 + step)
        p, ds = _splash_probs_and_ds(q, k, v, do, lse, di, grid, r0, r1)
        dk += torch.einsum("bhqk,bqhd->bkhd", rnd(ds), q[:, r0:r1])
        dv += torch.einsum("bhqk,bqhd->bkhd", rnd(p), do[:, r0:r1])
    return dk.to(dt), dv.to(dt)


def splash_attention_bwd_dq_ref(q, k, v, do, lse, di, tables, *,
                                q_chunk=None):
    """Plain version of the dQ kernel, over the dQ block list: dq = ds k,
    one chunk of query rows at a time. At bf16 ds is rounded to bf16 before
    ds k (splash_attention_kernel.py :1395), dq written in bf16."""
    q, k, v, do, rnd, dt = _plain_operands(q, k, v, do)
    B, L, H, _ = q.shape
    grid = tables.grid_on(q.device, "dq")
    dq = torch.empty_like(q)
    step = _splash_q_chunk(B, L, H, q_chunk)
    for r0 in range(0, L, step):
        r1 = min(L, r0 + step)
        _, ds = _splash_probs_and_ds(q, k, v, do, lse, di, grid, r0, r1)
        dq[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", rnd(ds), k)
    return dq.to(dt)


def _splash_checks(name, q, k, v, *, tables):
    """What the splash kernels take: q, k, v [B, L, H, D] in one of
    KERNEL_DTYPES, contiguous, D in SPLASH_HEAD_DIMS, L % 128 == 0, and tables
    made for (L, H)."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q, k, v [B, L, H, D]")
    B, L, H, D = q.shape
    blk = splash_mask.BLOCK
    if L % blk or L < blk:
        raise ValueError(f"{name}: L={L} is not a multiple of {blk}")
    if D not in SPLASH_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} is not one of "
                         f"{SPLASH_HEAD_DIMS}")
    if min(B, H) < 1 or max(B, H) > 65535:
        raise ValueError(f"{name}: unsupported shape {tuple(q.shape)}")
    dt = _kernel_dtype(name, q, k, v)
    for n, t in (("q", q), ("k", k), ("v", v)):
        _check(n, t, dt, (B, L, H, D))
    if tables.L != L or tables.rows not in (1, H):
        raise ValueError(f"{name}: tables for L={tables.L} with "
                         f"{tables.rows} head rows do not fit {tuple(q.shape)}")
    return B, L, H, D


def _table_args(tables, which, dev):
    counts, blocks, kinds = tables.on(dev, which)
    return ([counts.data_ptr(), blocks.data_ptr(), kinds.data_ptr()],
            [tables.rows, blocks.shape[2]])


def splash_attention_fwd(q, k, v, tables):
    """Splash forward. q (pre-scaled), k, v [B, L, H, D], all f32 or all
    bf16, L % 128 == 0, ``tables`` from `splash_mask.splash_tables(L, H,
    causal)` -> (o [B, L, H, D] in their dtype, lse [B, H, L] f32).

    CPU tensors run :func:`splash_attention_fwd_ref`. CUDA tensors launch
    the kernel of their dtype on the current stream, or raise."""
    dev = _device_of("splash_attention_fwd", [q, k, v])
    dt = _kernel_dtype("splash_attention_fwd", q, k, v)
    if dev.type == "cpu":
        return splash_attention_fwd_ref(q, k, v, tables)
    B, L, H, D = _splash_checks("splash_attention_fwd", q, k, v,
                                tables=tables)
    _check_aligned("splash_attention_fwd", q, k, v)
    lib = _lib("splash_attention_fwd")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        ptrs, dims = _table_args(tables, "fwd", dev)
        rc = getattr(lib, f"dl4j_splash_fwd_{_entry(dt)}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *ptrs, B, L, H, D, *dims, _stream(dev))
    _raise_on(rc, lib, "splash_attention_fwd")
    LAUNCHES[_launch_key("splash_attention_fwd", dt)] += 1
    return o, lse


def splash_attention_bwd_dkv(q, k, v, do, lse, di, tables):
    """Splash dK/dV backward. q (pre-scaled), k, v, do [B, L, H, D], all f32
    or all bf16, lse and di = sum_d o * do [B, H, L] f32 -> (dk, dv) [B, L,
    H, D] in q's dtype, the same bits on every launch.

    CPU tensors run :func:`splash_attention_bwd_dkv_ref`. CUDA tensors
    launch the kernel of their dtype on the current stream, or raise."""
    dev = _device_of("splash_attention_bwd_dkv", [q, k, v, do, lse, di])
    dt = _kernel_dtype("splash_attention_bwd_dkv", q, k, v, do)
    if dev.type == "cpu":
        return splash_attention_bwd_dkv_ref(q, k, v, do, lse, di, tables)
    B, L, H, D = _bwd_checks(
        "splash_attention_bwd_dkv", q, k, v, do, lse, di,
        checks=functools.partial(_splash_checks, tables=tables))
    _check_aligned("splash_attention_bwd_dkv", q, k, v, do)
    lib = _lib("splash_attention_bwd")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(dev):
        ptrs, dims = _table_args(tables, "dkv", dev)
        rc = getattr(lib, f"dl4j_splash_bwd_dkv_{_entry(dt)}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *ptrs, B, L, H, D, *dims, _stream(dev))
    _raise_on(rc, lib, "splash_attention_bwd_dkv")
    LAUNCHES[_launch_key("splash_attention_bwd_dkv", dt)] += 1
    return dk, dv


def splash_attention_bwd_dq(q, k, v, do, lse, di, tables):
    """Splash dQ backward: inputs as :func:`splash_attention_bwd_dkv` ->
    dq [B, L, H, D] in q's dtype (the gradient of the pre-scaled q), the
    same bits on every launch.

    CPU tensors run :func:`splash_attention_bwd_dq_ref`. CUDA tensors
    launch the kernel of their dtype on the current stream, or raise."""
    dev = _device_of("splash_attention_bwd_dq", [q, k, v, do, lse, di])
    dt = _kernel_dtype("splash_attention_bwd_dq", q, k, v, do)
    if dev.type == "cpu":
        return splash_attention_bwd_dq_ref(q, k, v, do, lse, di, tables)
    B, L, H, D = _bwd_checks(
        "splash_attention_bwd_dq", q, k, v, do, lse, di,
        checks=functools.partial(_splash_checks, tables=tables))
    _check_aligned("splash_attention_bwd_dq", q, k, v, do)
    lib = _lib("splash_attention_bwd")
    dq = torch.empty_like(q)
    with torch.cuda.device(dev):
        ptrs, dims = _table_args(tables, "dq", dev)
        rc = getattr(lib, f"dl4j_splash_bwd_dq_{_entry(dt)}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), *ptrs, B, L, H, D,
            *dims, _stream(dev))
    _raise_on(rc, lib, "splash_attention_bwd_dq")
    LAUNCHES[_launch_key("splash_attention_bwd_dq", dt)] += 1
    return dq
