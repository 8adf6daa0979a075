"""Weight initialization — the scheme of deeplearning4j_tpu/nn/weights.py
that ``transformer_lm`` uses (xavier, the net-level default). The other
schemes and ``weight_init="distribution"`` come with the slices whose
models use them.

Every draw takes an explicit `torch.Generator` and is made on the CPU,
then moved to the caller's device, so a seed gives the same weights on
the CPU and on the card. The port's draws are not the JAX package's
(threefry and torch's generator differ): tests that compare the two
packages copy parameters across (`util/model_serializer.params_from_jax`)
and compare the scheme by distribution only.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

XAVIER = "xavier"


def init_weights(gen: torch.Generator, shape: Sequence[int],
                 scheme: str = XAVIER, dtype: torch.dtype = torch.float32,
                 device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """Draw a [fan_in, fan_out] weight matrix from ``gen`` (a CPU
    generator): xavier is N(0, 2 / (fan_in + fan_out))."""
    if scheme.lower() != XAVIER:
        raise NotImplementedError(
            f"weight_init={scheme!r}: the port draws xavier weights only so "
            "far (the transformer_lm scheme)")
    fan_in, fan_out = (int(s) for s in shape)
    w = torch.randn((fan_in, fan_out), generator=gen) * math.sqrt(
        2.0 / (fan_in + fan_out))
    return w.to(device=device, dtype=dtype)
