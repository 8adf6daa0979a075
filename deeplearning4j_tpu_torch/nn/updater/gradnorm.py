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


def _split_sq(grads: Dict[str, Tensor], split, comm) -> Tensor:
    """The layer's squared L2 norm on a tensor-parallel rank: the split
    params' squared sums all-reduced over the axis, the replicated ones'
    added once."""
    rep = sum(torch.sum(g * g) for k, g in grads.items() if k not in split)
    part = sum(torch.sum(g * g) for k, g in grads.items() if k in split)
    if isinstance(part, Tensor):
        part = comm.all_reduce(part.clone())
    return rep + part


def apply_gradient_normalization(grads: Dict[str, Tensor], strategy: str,
                                 threshold: float = 1.0, split=(),
                                 comm=None) -> Dict[str, Tensor]:
    """``split``: the params of ``grads`` that a tensor-parallel rank
    holds a slice of; their norms are taken over the whole gradient,
    all-reduced over ``comm`` (the axis) before they divide."""
    s = (strategy or NONE).lower()
    if s == NONE:
        return grads
    split = set(split) & set(grads) if comm is not None else set()
    if s in (RENORMALIZE_L2_PER_LAYER, CLIP_L2_PER_LAYER):
        if split:
            total = torch.sqrt(_split_sq(grads, split, comm) + _EPS)
        else:
            total = torch.sqrt(sum(torch.sum(g * g)
                                   for g in grads.values()) + _EPS)
        if s == RENORMALIZE_L2_PER_LAYER:
            return {k: g / total for k, g in grads.items()}
        scale = torch.where(total > threshold, threshold / total, 1.0)
        return {k: g * scale for k, g in grads.items()}

    def l2(k, g):
        if k in split:
            return torch.sqrt(comm.all_reduce(torch.sum(g * g)))
        return _l2(g)
    if s == RENORMALIZE_L2_PER_PARAM_TYPE:
        return {k: g / (l2(k, g) + _EPS) for k, g in grads.items()}
    if s == CLIP_ELEMENT_WISE_ABSOLUTE_VALUE:
        return {k: torch.clamp(g, -threshold, threshold)
                for k, g in grads.items()}
    if s == CLIP_L2_PER_PARAM_TYPE:
        out = {}
        for k, g in grads.items():
            n = l2(k, g) + _EPS
            out[k] = g * torch.where(n > threshold, threshold / n, 1.0)
        return out
    raise ValueError(f"Unknown gradient normalization '{strategy}'. "
                     f"Available: {ALL}")
