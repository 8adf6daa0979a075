"""Accelerated-op helper seam — port of deeplearning4j_tpu/ops/helpers.py
(the registry and the paged-decode seam; the conv / pool / BN / LSTM /
full-sequence attention seams come with the slices that run them).

A registry of op implementations: `register_helper(name, fn)` overrides
an op, `register_helper(name, None)` restores its default. The default
of ``paged_decode_attention`` is the hand-written CUDA kernel's wrapper
(`ops/cuda_kernels.py`): kernel on CUDA tensors, plain version on CPU
tensors. There is no per-shape autotune and no silent fallback on the
card: the seam's ``None`` arm exists only for the cases the JAX seam
declines as well, and then the layer runs its own gather body.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

_HELPERS: Dict[str, Callable] = {}


def register_helper(name: str, fn: Optional[Callable]) -> None:
    """Override the implementation of an op; None restores the default."""
    if fn is None:
        _HELPERS.pop(name, None)
    else:
        _HELPERS[name] = fn


def get_helper(name: str) -> Optional[Callable]:
    return _HELPERS.get(name)


def _paged_decode_default(q, k_pages, v_pages, table, pos, *, k_scales=None,
                          v_scales=None):
    from .cuda_kernels import paged_decode_attention as kernel
    return kernel(q, k_pages, v_pages, table, pos, k_scales=k_scales,
                  v_scales=v_scales)


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
