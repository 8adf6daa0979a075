"""Gradient normalization strategies — port of
deeplearning4j_tpu/nn/updater/gradnorm.py. Operates on one layer's dict
of param name -> gradient.
"""
from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor

NONE = "none"
RENORMALIZE_L2_PER_LAYER = "renormalizel2perlayer"
RENORMALIZE_L2_PER_PARAM_TYPE = "renormalizel2perparamtype"
CLIP_ELEMENT_WISE_ABSOLUTE_VALUE = "clipelementwiseabsolutevalue"
CLIP_L2_PER_LAYER = "clipl2perlayer"
CLIP_L2_PER_PARAM_TYPE = "clipl2perparamtype"

ALL = (NONE, RENORMALIZE_L2_PER_LAYER, RENORMALIZE_L2_PER_PARAM_TYPE,
       CLIP_ELEMENT_WISE_ABSOLUTE_VALUE, CLIP_L2_PER_LAYER,
       CLIP_L2_PER_PARAM_TYPE)

_EPS = 1e-8


def _l2(x: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(x * x))


def apply_gradient_normalization(grads: Dict[str, Tensor], strategy: str,
                                 threshold: float = 1.0) -> Dict[str, Tensor]:
    s = (strategy or NONE).lower()
    if s == NONE:
        return grads
    if s in (RENORMALIZE_L2_PER_LAYER, CLIP_L2_PER_LAYER):
        total = torch.sqrt(sum(torch.sum(g * g) for g in grads.values())
                           + _EPS)
        if s == RENORMALIZE_L2_PER_LAYER:
            return {k: g / total for k, g in grads.items()}
        scale = torch.where(total > threshold, threshold / total, 1.0)
        return {k: g * scale for k, g in grads.items()}
    if s == RENORMALIZE_L2_PER_PARAM_TYPE:
        return {k: g / (_l2(g) + _EPS) for k, g in grads.items()}
    if s == CLIP_ELEMENT_WISE_ABSOLUTE_VALUE:
        return {k: torch.clamp(g, -threshold, threshold)
                for k, g in grads.items()}
    if s == CLIP_L2_PER_PARAM_TYPE:
        out = {}
        for k, g in grads.items():
            n = _l2(g) + _EPS
            out[k] = g * torch.where(n > threshold, threshold / n, 1.0)
        return out
    raise ValueError(f"Unknown gradient normalization '{strategy}'. "
                     f"Available: {ALL}")
