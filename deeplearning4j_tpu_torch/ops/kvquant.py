"""Int8 KV-cache row quantization — the port's copy of the shared contract
(deeplearning4j_tpu/ops/kvquant.py).

Consumers: the paged attention step's write-side quantize and gather-side
dequantize (nn/layers/attention.py), the plain paged-decode version
(ops/cuda_kernels.py), and the CUDA kernel's in-loop dequant
(ops/csrc/paged_decode_attention.cu), which repeats the cast-then-multiply
below in float32.

Contract:

  - scale is max-abs over the LAST axis (the head dim) divided by 127,
    floored at ``SCALE_FLOOR`` = 1e-8 so an all-zero row quantizes to
    zeros instead of 0/0 NaNs;
  - values round half to even (`torch.round`, as `jnp.round`) then clip
    to [-127, 127]: the int8 -128 code is never produced;
  - dequantize casts first, then multiplies, in the CALLER's dtype.
"""
from __future__ import annotations

from typing import Tuple

import torch

SCALE_FLOOR = 1e-8


def quantize_kv_rows(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., Dh]`` float rows -> (int8 rows ``[..., Dh]``, f32 scales
    ``[...]``): one symmetric max-abs scale per leading index."""
    s = torch.amax(torch.abs(a), dim=-1) / 127.0
    s = torch.clamp_min(s, SCALE_FLOOR)
    rows = torch.clamp(torch.round(a / s[..., None]), -127, 127)
    return rows.to(torch.int8), s.to(torch.float32)


def dequantize_kv_rows(rows: torch.Tensor, scales: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """int8 rows ``[..., Dh]`` x f32 scales ``[...]`` -> float rows in
    ``dtype``, cast then multiply."""
    return rows.to(dtype) * scales[..., None].to(dtype)
