"""The networks' precision rules, shared by MultiLayerNetwork and
ComputationGraph — port of the JAX package's `_dtype_of`,
`_compute_dtype_of` and `_cast_floats` (nn/multilayer.py :42-66, which
nn/graph.py imports).

Parameters (and BatchNorm variables) are made at ``conf.dtype``: float32,
bfloat16 or float64. The forward runs at ``conf.compute_dtype`` when it
is set (mixed precision: the masters are cast to it in the forward, so
autograd hands gradients at the masters' dtype back to them), else at the
parameter dtype. Inputs arrive at f32 (f64 for an f64 net), as JAX
arrays do, and the forward casts them to the compute dtype.
"""
from __future__ import annotations

import numpy as np
import torch

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float64": torch.float64}


def dtype_of(conf) -> torch.dtype:
    """The parameter dtype (JAX multilayer.py :42): bfloat16 and float64
    by name, float32 for anything else."""
    return {"bfloat16": torch.bfloat16,
            "float64": torch.float64}.get(conf.dtype, torch.float32)


def compute_dtype_of(conf) -> torch.dtype:
    """Forward/backward compute dtype: ``compute_dtype`` when set (mixed
    precision with the masters at the parameter dtype), else the
    parameter dtype (JAX multilayer.py :50). An unsupported
    ``compute_dtype`` raises ValueError."""
    cd = getattr(conf, "compute_dtype", None)
    if cd:
        if cd not in COMPUTE_DTYPES:
            raise ValueError(f"Unsupported compute_dtype '{cd}' "
                             f"(supported: {sorted(COMPUTE_DTYPES)})")
        return COMPUTE_DTYPES[cd]
    return dtype_of(conf)


def cast_floats(params, dtype):
    """Per-layer param dicts — a list (MultiLayerNetwork) or a dict by
    layer name (ComputationGraph) — with every floating tensor cast to
    ``dtype``: a differentiable cast, so the gradient flows back to the
    masters."""
    def cast(lp):
        return {k: v.to(dtype) if v.is_floating_point() else v
                for k, v in lp.items()}
    if isinstance(params, dict):
        return {name: cast(lp) for name, lp in params.items()}
    return [cast(lp) for lp in params]


def input_dtype(param_dtype: torch.dtype) -> torch.dtype:
    """The dtype float inputs and labels arrive at: f64 for an f64 net,
    f32 otherwise (JAX arrays default to f32); the forward casts inputs to
    the compute dtype and the losses take the labels as they are."""
    return torch.float64 if param_dtype == torch.float64 else torch.float32


def host_array(t: torch.Tensor):
    """``t`` as a numpy array on the host; bf16 comes as f32 (exact), numpy
    having no bf16 of its own."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def host_floats(a):
    """A numpy array as given, but a bf16 one (ml_dtypes', e.g. a JAX bf16
    net's ``params_flat``) as f32 (exact), which torch can take."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
