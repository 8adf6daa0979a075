"""Loss functions — port of deeplearning4j_tpu/ops/losses.py.

Each loss takes (labels, preds) with an optional per-example mask and
returns the summed-over-outputs, mean-over-examples scalar score, as the
JAX package computes it. The from-logits losses (`fused_from_logits`)
take PRE-activation outputs: their gradient with respect to the logits
is exactly softmax(z) - y (resp. sigmoid(z) - y), never clipped.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_EPS = 1e-8


def _reduce(per_example: Tensor, mask: Optional[Tensor]) -> Tensor:
    """Sum over output dims already done; average over (masked) examples."""
    if mask is not None:
        m = mask.reshape((per_example.shape[0],) + (1,) * (per_example.ndim - 1))
        per_example = (per_example * m.squeeze() if per_example.ndim == 1
                       else per_example * m)
        denom = torch.clamp_min(torch.sum(mask), 1.0)
        return torch.sum(per_example) / denom
    return torch.mean(per_example)


def mse(labels: Tensor, preds: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    return _reduce(torch.sum((labels - preds) ** 2, dim=-1), mask)


def squared_loss(labels, preds, mask=None):
    return mse(labels, preds, mask)


def l1(labels, preds, mask=None):
    return _reduce(torch.sum(torch.abs(labels - preds), dim=-1), mask)


def l2(labels, preds, mask=None):
    return mse(labels, preds, mask)


def xent(labels, preds, mask=None):
    """Binary cross entropy (reference XENT)."""
    p = torch.clamp(preds, _EPS, 1.0 - _EPS)
    per_ex = -torch.sum(labels * torch.log(p)
                        + (1.0 - labels) * torch.log(1.0 - p), dim=-1)
    return _reduce(per_ex, mask)


def mcxent(labels, preds, mask=None):
    """Multi-class cross entropy against probabilities (reference MCXENT)."""
    p = torch.clamp(preds, _EPS, 1.0)
    return _reduce(-torch.sum(labels * torch.log(p), dim=-1), mask)


def negativeloglikelihood(labels, preds, mask=None):
    return mcxent(labels, preds, mask)


def rmse_xent(labels, preds, mask=None):
    per_ex = torch.sqrt(torch.sum((labels - preds) ** 2, dim=-1) + _EPS)
    return _reduce(per_ex, mask)


def expll(labels, preds, mask=None):
    """Exponential log likelihood (Poisson-style, reference EXPLL)."""
    p = torch.clamp_min(preds, _EPS)
    return _reduce(torch.sum(p - labels * torch.log(p), dim=-1), mask)


def reconstruction_crossentropy(labels, preds, mask=None):
    return xent(labels, preds, mask)


def hinge(labels, preds, mask=None):
    """Hinge loss; labels expected in {-1, +1} or one-hot (converted)."""
    lab = torch.where(labels > 0, 1.0, -1.0).to(preds.dtype)
    per_ex = torch.sum(torch.clamp_min(1.0 - lab * preds, 0.0), dim=-1)
    return _reduce(per_ex, mask)


def softmax_mcxent_from_logits(labels: Tensor, logits: Tensor,
                               mask: Optional[Tensor] = None) -> Tensor:
    """``-sum(y * log_softmax(z))`` in f32 from PRE-activation logits:
    its gradient in z is exactly softmax(z) - y (JAX losses.py:96)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return _reduce(-torch.sum(labels.float() * logp, dim=-1), mask)


def sigmoid_xent_from_logits(labels: Tensor, logits: Tensor,
                             mask: Optional[Tensor] = None) -> Tensor:
    """Binary cross entropy from logits, in the stable softplus form."""
    z = logits.float()
    y = labels.float()
    per = torch.clamp_min(z, 0.0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
    return _reduce(torch.sum(per, dim=-1), mask)


# (activation, loss) pairs with a numerically stable from-logits form; the
# train and score paths feed these the output layer's PRE-activation
_FUSED_FROM_LOGITS: dict[tuple, Callable[..., Tensor]] = {
    ("softmax", "mcxent"): softmax_mcxent_from_logits,
    ("softmax", "negativeloglikelihood"): softmax_mcxent_from_logits,
    ("softmax", "nll"): softmax_mcxent_from_logits,
    ("sigmoid", "xent"): sigmoid_xent_from_logits,
}


def fused_from_logits(activation, loss_name) -> Optional[Callable[..., Tensor]]:
    if activation is None or loss_name is None:
        return None
    return _FUSED_FROM_LOGITS.get((str(activation).lower(),
                                   str(loss_name).lower()))


LOSSES: dict[str, Callable[..., Tensor]] = {
    "mse": mse,
    "squared_loss": squared_loss,
    "l1": l1,
    "l2": l2,
    "xent": xent,
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "nll": negativeloglikelihood,
    "rmse_xent": rmse_xent,
    "expll": expll,
    "reconstruction_crossentropy": reconstruction_crossentropy,
    "hinge": hinge,
}


def get(name: str) -> Callable[..., Tensor]:
    try:
        return LOSSES[name.lower()]
    except KeyError:
        raise ValueError(f"Unknown loss '{name}'. Available: "
                         f"{sorted(LOSSES)}") from None
