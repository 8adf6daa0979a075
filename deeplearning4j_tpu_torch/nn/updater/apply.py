"""One layer's optimizer step — the body of the JAX package's
`_apply_updaters` (multilayer.py :262, graph.py :275), shared by the
port's MultiLayerNetwork and ComputationGraph: gradient normalization,
the lr schedule, the bias lr, the updater's rule, decoupled weight decay.
Updater state is f32 whatever the parameter dtype; a bf16 parameter takes
its lr rounded to bf16 and a delta computed in f32 and cast to bf16, as in
the JAX package (updaters.py :33-37).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .gradnorm import apply_gradient_normalization
from .schedules import effective_lr

Tensor = torch.Tensor


@torch.no_grad()
def update_layer(layer_conf, gconf, weight_keys, params: Dict[str, Tensor],
                 grads: Dict[str, Tensor], ustates: Dict[str, dict],
                 step: int) -> Tuple[Dict[str, Tensor], Dict[str, dict]]:
    """(new params, new updater states) of one layer whose resolved config
    is ``layer_conf``; ``gconf`` the network's NeuralNetConfiguration,
    ``weight_keys`` the params weight decay applies to."""
    grads = apply_gradient_normalization(
        grads, layer_conf.gradient_normalization or "none",
        layer_conf.gradient_normalization_threshold or 1.0)
    updater = layer_conf.updater
    base_lr = updater_lr = getattr(updater, "learning_rate", -1.0)
    if updater_lr is None or updater_lr < 0:
        base_lr = layer_conf.learning_rate
    bias_lr = layer_conf.bias_learning_rate or base_lr
    wd = float(getattr(updater, "weight_decay", 0.0) or 0.0)
    new_params, new_states = {}, {}
    for name, g in grads.items():
        lr0 = bias_lr if name in ("b", "vb", "beta") else base_lr
        lr = effective_lr(lr0, step, gconf.lr_policy,
                          gconf.lr_policy_decay_rate, gconf.lr_policy_power,
                          gconf.lr_policy_steps, gconf.max_num_iterations,
                          gconf.lr_schedule)
        p = params[name]
        if g.dtype != torch.float32:
            # the lr in the gradient's dtype, as JAX rounds it (graph.py
            # :301), and the decay in the param's (:305); the updaters then
            # compute in f32 and cast the delta to the gradient's dtype
            lr = float(torch.tensor(lr, dtype=g.dtype))
        delta, new_state = updater.apply(ustates[name], g, lr, step)
        if wd and name in weight_keys:  # decoupled (AdamW-style) decay
            if p.dtype == torch.float32:
                delta = delta - float(np.float32(lr) * np.float32(wd)) * p
            else:
                delta = delta - (torch.tensor(lr, dtype=p.dtype)
                                 * torch.tensor(wd, dtype=p.dtype)).to(
                                     p.device) * p
        new_params[name] = p + delta
        new_states[name] = new_state
    return new_params, new_states
