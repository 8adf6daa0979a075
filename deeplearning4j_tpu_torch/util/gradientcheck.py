"""Numerical gradient checking — port of
deeplearning4j_tpu/util/gradientcheck.py.

Central differences of a MultiLayerNetwork's loss, one parameter at a
time, against the analytic gradient `torch.autograd.grad` takes of the
same loss: the inference-mode forward (running BatchNorm statistics, no
dropout) from the net's variables, the output layer's loss on its
activation (not the fused from-logits form), plus each layer's l1/l2
term. Parameters are walked in `params_flat` order. The defaults are the
JAX package's and the reference's (eps 1e-6, max relative error 1e-3,
min absolute error 1e-9), which assume a float64 net
(``.dtype("float64")``). On the card a float64 net runs the plain paths
wherever the JAX seams decline a kernel (a conv whose kw * c is below 8,
inference-mode BatchNorm, the recurrent layers); a shape the conv kernel
takes raises, the kernels having no float64 variant.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _loss_fn(net, x, y, fmask, lmask):
    def loss(params):
        acts = net._forward_impl(params, net.variables, x, train=False,
                                 fmask=fmask)[0]
        return net._loss_from_output(acts[-1], y, lmask) + \
            net._reg_loss(params)
    return loss


def _inputs(net, x, y, fmask, lmask):
    net._check_init()
    return (net._as_tensor(x), net._as_tensor(y), net._as_tensor(fmask),
            net._as_tensor(lmask))


def analytic_gradient(net, x, y, fmask=None, lmask=None) -> np.ndarray:
    """The gradient `check_gradients` checks, flat in `params_flat` order,
    as float64."""
    loss_fn = _loss_fn(net, *_inputs(net, x, y, fmask, lmask))
    params = [{k: v.detach().requires_grad_(True) for k, v in lp.items()}
              for lp in net.params]
    order = [(i, k) for i, lp in enumerate(params) for k in sorted(lp)]
    leaves = [params[i][k] for i, k in order]
    grads = torch.autograd.grad(loss_fn(params), leaves, allow_unused=True)
    chunks = [np.zeros(t.numel()) if g is None
              else g.detach().cpu().double().numpy().reshape(-1)
              for t, g in zip(leaves, grads)]
    return np.concatenate(chunks) if chunks else np.zeros(0)


def check_gradients(
    net,
    x,
    y,
    epsilon: float = 1e-6,
    max_rel_error: float = 1e-3,
    min_abs_error: float = 1e-9,
    fmask=None,
    lmask=None,
    print_results: bool = False,
    max_params_checked: Optional[int] = None,
) -> bool:
    """Compare the analytic gradient with central differences on ``net``
    (JAX :19). Returns True if every checked parameter passes: its
    relative error at most ``max_rel_error`` or its absolute error at
    most ``min_abs_error``."""
    loss_fn = _loss_fn(net, *_inputs(net, x, y, fmask, lmask))
    flat_analytic = analytic_gradient(net, x, y, fmask, lmask)
    flat_params = np.concatenate(
        [net.params[i][k].detach().cpu().double().numpy().reshape(-1)
         for i, lp in enumerate(net.params) for k in sorted(lp)]) \
        if net.num_params() else np.zeros(0)
    like = net.params

    @torch.no_grad()
    def loss_of_flat(flat: np.ndarray) -> float:
        return float(loss_fn(_unflatten(flat, like)))

    n = flat_params.size if max_params_checked is None else min(
        flat_params.size, max_params_checked)
    fails = 0
    for i in range(n):
        orig = flat_params[i]
        flat_params[i] = orig + epsilon
        plus = loss_of_flat(flat_params)
        flat_params[i] = orig - epsilon
        minus = loss_of_flat(flat_params)
        flat_params[i] = orig
        numeric = (plus - minus) / (2.0 * epsilon)
        a = flat_analytic[i]
        abs_err = abs(a - numeric)
        denom = max(abs(a), abs(numeric))
        rel_err = abs_err / denom if denom > 0 else 0.0
        if not (rel_err <= max_rel_error or abs_err <= min_abs_error):
            fails += 1
            if print_results:
                print(f"param {i}: analytic={a:.8g} numeric={numeric:.8g} "
                      f"relErr={rel_err:.3g}")
    if print_results:
        print(f"gradient check: {n - fails}/{n} passed")
    return fails == 0


def _unflatten(flat: np.ndarray, like):
    """Per-layer dicts of tensors shaped, typed and placed as ``like``'s,
    read from ``flat`` in `params_flat` order."""
    out, off = [], 0
    for lp in like:
        nlp = {}
        for name in sorted(lp):
            t = lp[name]
            nlp[name] = torch.from_numpy(
                flat[off:off + t.numel()].reshape(tuple(t.shape))).to(
                device=t.device, dtype=t.dtype)
            off += t.numel()
        out.append(nlp)
    return out
