"""Hand-written Hopper kernels of the port: wrappers, plain versions, counts.

Counterpart of the paged-decode section of
deeplearning4j_tpu/ops/pallas_kernels.py (:726-1085). The kernel itself
is CUDA C++ in ``ops/csrc/paged_decode_attention.cu``, compiled for
sm_90a by nvcc at first use and bound with ctypes (``ops/_build.py``).

Rule of every wrapper here:

  - a tensor on the CPU runs the plain PyTorch version (the tests' path);
  - a tensor on a CUDA device launches the kernel, or raises: no fallback
    when the shape is unsupported or the build fails;
  - each launch adds one to ``LAUNCHES[<kernel>]`` — and nothing else
    does — so a run can show its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .kvquant import dequantize_kv_rows

LAUNCHES = {"paged_decode_attention": 0}

_KERNEL_SOURCE = "paged_decode_attention"
# the kernel keeps G * Dh accumulators in registers: 128 threads x 16
_MAX_GROUP_DIM = 128 * 16
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


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


def _lib():
    lib = _build.load(_KERNEL_SOURCE)
    if not getattr(lib, "_dl4j_bound", False):
        lib.dl4j_paged_decode_f32.argtypes = [_PTR] * 6 + [_INT] * 6 + [_PTR]
        lib.dl4j_paged_decode_f32.restype = _INT
        lib.dl4j_paged_decode_i8.argtypes = [_PTR] * 8 + [_INT] * 6 + [_PTR]
        lib.dl4j_paged_decode_i8.restype = _INT
        lib.dl4j_cuda_error_string.argtypes = [_INT]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
        lib._dl4j_bound = True
    return lib


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
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError("paged_decode_attention: all inputs must be on "
                         f"one device (q is on {dev})")
    if dev.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, table, pos,
                                          k_scales=k_scales,
                                          v_scales=v_scales)
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {dev}")
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
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = _PTR(torch.cuda.current_stream(dev).cuda_stream)
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
    if rc != 0:
        raise RuntimeError(
            "paged_decode_attention kernel launch failed: "
            f"{lib.dl4j_cuda_error_string(rc).decode()} (cudaError {rc})")
    LAUNCHES["paged_decode_attention"] += 1
    return out
