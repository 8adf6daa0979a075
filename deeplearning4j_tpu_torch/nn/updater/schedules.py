"""Learning-rate decay policies — port of
deeplearning4j_tpu/nn/updater/schedules.py.

`effective_lr` returns the scheduled rate for a 0-based iteration as a
Python float holding a float32 value: the JAX package computes it in
float32, and the port does the same arithmetic in numpy float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

POLICIES = ("none", "exponential", "inverse", "poly", "sigmoid", "step",
            "schedule", "warmup_cosine")


def effective_lr(base_lr: float, iteration: int, policy: str = "none",
                 decay_rate: float = 0.0, power: float = 1.0,
                 steps: float = 1.0, max_iterations: int = 1,
                 schedule: Optional[Dict[str, float]] = None) -> float:
    """The scheduled learning rate for ``iteration`` (0-based)."""
    f = np.float32
    it = f(iteration)
    lr = f(base_lr)
    policy = (policy or "none").lower()
    if policy == "none":
        out = lr
    elif policy == "exponential":
        out = lr * np.power(f(decay_rate), it)
    elif policy == "inverse":
        out = lr / np.power(f(1.0) + f(decay_rate) * it, f(power))
    elif policy == "poly":
        frac = np.clip(it / f(max(float(max_iterations), 1.0)), f(0.0), f(1.0))
        out = lr * np.power(f(1.0) - frac, f(power))
    elif policy == "sigmoid":
        out = lr / (f(1.0) + np.exp(f(decay_rate) * (it - f(steps))))
    elif policy == "step":
        out = lr * np.power(f(decay_rate), np.floor(it / f(steps)))
    elif policy == "schedule":
        # piecewise constant: the value of the largest key <= iteration
        out = lr
        for k, v in sorted((int(k), float(v))
                           for k, v in (schedule or {}).items()):
            if it >= k:
                out = f(v)
    elif policy == "warmup_cosine":
        # linear warmup over `steps` iterations from 0 to base_lr, then
        # cosine decay to base_lr * decay_rate by max_iterations
        warm = f(max(float(steps), 1.0))
        floor_frac = f(decay_rate)
        if it < warm:
            out = lr * it / warm
        else:
            span = f(max(float(max_iterations) - float(warm), 1.0))
            prog = np.clip((it - warm) / span, f(0.0), f(1.0))
            out = lr * (floor_frac + (f(1.0) - floor_frac) * f(0.5)
                        * (f(1.0) + np.cos(f(math.pi) * prog)))
    else:
        raise ValueError(f"Unknown lr policy '{policy}'. Available: "
                         f"{POLICIES}")
    return float(f(out))
