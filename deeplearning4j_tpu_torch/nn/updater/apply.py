"""One layer's optimizer step — the body of the JAX package's
`_apply_updaters` (multilayer.py :262, graph.py :275), shared by the
port's MultiLayerNetwork and ComputationGraph: gradient normalization,
the lr schedule, the bias lr, the updater's rule, decoupled weight decay.
Updater state is f32 whatever the parameter dtype; a bf16 parameter takes
its lr rounded to bf16 and a delta computed in f32 and cast to bf16, as in
the JAX package (updaters.py :33-37).

The step is split in two. `layer_scalars` computes on the host, in numpy
float32 as JAX does, every value that depends on the step; the facades
pack them into one row that is copied to the device before each step
(nn/step_graph.py). `update_layer_` runs on the device, reads its scalars
from that row and writes the new parameters and updater state into the
net's own tensors, in place, so that a captured step replays it.
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch

from .gradnorm import apply_gradient_normalization
from .schedules import effective_lr

Tensor = torch.Tensor
BIAS_KEYS = ("b", "vb", "beta")


def _rates(layer_conf):
    """(base lr, bias lr, weight decay) of a resolved layer config."""
    updater = layer_conf.updater
    base_lr = updater_lr = getattr(updater, "learning_rate", -1.0)
    if updater_lr is None or updater_lr < 0:
        base_lr = layer_conf.learning_rate
    bias_lr = layer_conf.bias_learning_rate or base_lr
    wd = float(getattr(updater, "weight_decay", 0.0) or 0.0)
    return base_lr, bias_lr, wd


def layer_scalars(layer_conf, gconf, weight_keys, params: Dict[str, Tensor],
                  step: int, *, bias_lr: bool = True) -> List[float]:
    """The step's scalars of one layer whose resolved config is
    ``layer_conf`` (``gconf`` the network's NeuralNetConfiguration),
    param by param in ``params`` order: the updater's ``scalars`` (the
    scheduled lr first), then lr * weight decay where the decay applies
    (``weight_keys``). ``bias_lr`` False gives the biases the base lr
    (the JAX pretrain step, multilayer.py :746)."""
    base_lr, blr, wd = _rates(layer_conf)
    out: List[float] = []
    for name, p in params.items():
        lr0 = blr if bias_lr and name in BIAS_KEYS else base_lr
        lr = effective_lr(lr0, step, gconf.lr_policy,
                          gconf.lr_policy_decay_rate, gconf.lr_policy_power,
                          gconf.lr_policy_steps, gconf.max_num_iterations,
                          gconf.lr_schedule)
        if p.dtype != torch.float32:
            # the lr in the gradient's dtype, as JAX rounds it (graph.py
            # :301), and the decay in the param's (:305)
            lr = float(torch.tensor(lr, dtype=p.dtype))
        out.extend(layer_conf.updater.scalars(lr, step))
        if wd and name in weight_keys:  # decoupled (AdamW-style) decay
            if p.dtype == torch.float32:
                out.append(float(np.float32(lr) * np.float32(wd)))
            else:
                out.append(float(torch.tensor(lr, dtype=p.dtype)
                                 * torch.tensor(wd, dtype=p.dtype)))
    return out


@torch.no_grad()
def update_layer_(layer_conf, weight_keys, params: Dict[str, Tensor],
                  grads: Dict[str, Tensor], ustates: Dict[str, dict],
                  row: Iterator, split=(), comm=None, zero=None) -> None:
    """One layer's update, in place: ``params`` and ``ustates`` (the
    net's own tensors) take their new values; the scalars come from
    ``row``, an iterator over the values `layer_scalars` computed for this
    layer (0-d device tensors in the train step). ``split`` / ``comm``: a
    tensor-parallel rank's split params and axis (gradient normalization
    over the whole gradient). ``zero``: ZeRO-1 (parallel/zero.py), a pair
    of this layer's {param: dim} and the data axis communicator — such a
    param's state holds this rank's slice along the dim, so the rank
    updates that slice of the param (the gradient normalized whole
    first) and all-gathers the updated slices."""
    grads = apply_gradient_normalization(
        grads, layer_conf.gradient_normalization or "none",
        layer_conf.gradient_normalization_threshold or 1.0, split, comm)
    updater = layer_conf.updater
    n = len(updater.scalars(0.0, 0))
    wd = _rates(layer_conf)[2]
    dims, zcomm = zero if zero is not None else ({}, None)
    for name, g in grads.items():
        s = [next(row) for _ in range(n)]
        full = params[name]
        d = dims.get(name)
        p = full
        if d is not None:
            c = full.shape[d] // zcomm.size
            p = full.narrow(d, zcomm.rank * c, c)
            g = g.narrow(d, zcomm.rank * c, c)
        delta, new_state = updater.update(ustates[name], g, s)
        if wd and name in weight_keys:
            wlr = next(row)
            if isinstance(wlr, Tensor) and wlr.dtype != p.dtype:
                wlr = wlr.to(p.dtype)
            delta = delta - wlr * p
        if d is None:
            p.add_(delta)
        else:
            full.copy_(zcomm.all_gather(p + delta, d))
        for k, t in new_state.items():
            ustates[name][k].copy_(t)
