"""Layer implementation SPI + registry — port of
deeplearning4j_tpu/nn/layers/base.py.

A layer impl is a thin stateless object bound to its resolved config;
params live outside it in a dict name -> tensor (the JAX package's
pytree, in the same layout: a Dense ``W`` is [n_in, n_out] and computes
``x @ W + b``; a conv ``W`` is HWIO), and ``forward`` is a plain function
on tensors whose backward autograd derives. Non-trainable state (the
BatchNorm running stats) rides in ``variables``; `forward_with_variables`
returns the updated dict.

Randomness (dropout) takes an explicit `torch.Generator` on the tensor's
device: the port's masks are not the JAX package's, so tests that
compare the two set dropout to 0.

`remat_forward` is the layer-granularity rematerialization of
``NeuralNetConfiguration.remat``: `torch.utils.checkpoint` in place of
`jax.checkpoint`.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple, Type

import torch
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor
Params = Dict[str, Tensor]
Variables = Dict[str, Tensor]

LAYER_IMPLS: Dict[str, Type["LayerImpl"]] = {}


class _MaskTape:
    """The dropout masks one checkpointed layer drew at its forward,
    handed back in order to its recomputation. Active on the thread that
    runs the layer (the caller's at the forward, the autograd engine's at
    the recomputation)."""

    _active = threading.local()

    def __init__(self):
        self.masks: List[Tensor] = []
        self.recorded = False
        self.pos = 0

    def __enter__(self):
        self._active.tape = self
        self.pos = 0
        return self

    def __exit__(self, *exc):
        self._active.tape = None
        self.recorded = True  # every later entry replays

    def mask(self, shape, keep: float, gen, device) -> Tensor:
        if not self.recorded:
            m = dropout_mask(shape, keep, gen, device, taped=False)
            self.masks.append(m)
            return m
        m = self.masks[self.pos]
        self.pos += 1
        return m


def dropout_mask(shape, keep: float, gen: torch.Generator, device, *,
                 taped: bool = True) -> Tensor:
    """One dropout draw: True where a unit is kept (a uniform from
    ``gen`` below ``keep``); inside a remat layer, the draw its forward
    recorded."""
    tape = getattr(_MaskTape._active, "tape", None) if taped else None
    if tape is not None:
        return tape.mask(shape, keep, gen, device)
    return torch.rand(shape, generator=gen, device=device) < keep


def remat_forward(impl, *, train: bool, ckpt: bool, recurrent: bool):
    """A layer impl's forward in positional form (JAX base.py :28) —
    recurrent: f(params, x, state0, gen, mask) -> (y, state); otherwise
    f(params, x, variables, gen, mask) -> (y, variables) — and, when
    ``ckpt``, under `torch.utils.checkpoint` (non-reentrant): the backward
    recomputes the layer's internals instead of keeping them.

    The recomputation must draw the dropout masks the forward drew (what
    `jax.checkpoint` gets by replaying the same key). The forward records
    its masks (one bool per unit) and the recomputation takes them back,
    so neither touches the generator again: a generator's state cannot be
    read or set inside a CUDA graph capture, and the train step is
    captured (nn/step_graph.py). For the same reason checkpoint does not
    stash the global RNG states (no layer draws from them)."""
    if recurrent:
        def fwd(p, x, s, gen, m):
            return impl.forward_with_state(p, x, s, train=train, gen=gen,
                                           mask=m)
    else:
        def fwd(p, x, v, gen, m):
            return impl.forward_with_variables(p, x, v, train=train, gen=gen,
                                               mask=m)
    if not ckpt:
        return fwd

    def run(p, x, s, gen, m):
        tape = _MaskTape()

        def body(p, x):
            with tape:
                return fwd(p, x, s, gen, m)
        return checkpoint(body, p, x, use_reentrant=False,
                          preserve_rng_state=False)
    return run


def register_impl(conf_cls_name: str):
    def deco(cls):
        LAYER_IMPLS[conf_cls_name] = cls
        return cls
    return deco


def impl_for(conf) -> "LayerImpl":
    name = type(conf).__name__
    if name not in LAYER_IMPLS:
        raise ValueError(f"No layer implementation registered for config {name}")
    return LAYER_IMPLS[name](conf)


class LayerImpl:
    """Stateless functional layer bound to a resolved config."""

    # weight params regularized by l1/l2 (biases excluded, as the JAX
    # package and the reference's BaseLayer.calcL2 do)
    WEIGHT_KEYS = ("W",)

    def __init__(self, conf):
        self.conf = conf

    def init_params(self, gen: torch.Generator, dtype=torch.float32,
                    device=torch.device("cpu")) -> Params:
        return {}

    def init_variables(self, dtype=torch.float32,
                       device=torch.device("cpu")) -> Variables:
        return {}

    def forward(self, params: Params, x: Tensor, *, train: bool = False,
                gen: Optional[torch.Generator] = None,
                mask: Optional[Tensor] = None) -> Tensor:
        raise NotImplementedError

    def forward_with_variables(self, params: Params, x: Tensor,
                               variables: Variables, *, train: bool = False,
                               gen: Optional[torch.Generator] = None,
                               mask: Optional[Tensor] = None
                               ) -> Tuple[Tensor, Variables]:
        """(activations, updated variables); a layer without variables
        returns its input dict."""
        return self.forward(params, x, train=train, gen=gen,
                            mask=mask), variables

    def regularized(self) -> bool:
        """Whether the layer has an l1 or l2 term."""
        return bool(float(getattr(self.conf, "l1", 0.0) or 0.0)
                    or float(getattr(self.conf, "l2", 0.0) or 0.0))

    def reg_loss(self, params: Params, only=None, exclude=()) -> Tensor:
        """0.5 * l2 * sum(W^2) + l1 * sum(|W|) over WEIGHT_KEYS (those in
        ``only``, when given, and not in ``exclude``: a tensor-parallel
        rank's split and replicated weights), in f32 or wider (JAX
        base.py :103)."""
        l1 = float(getattr(self.conf, "l1", 0.0) or 0.0)
        l2 = float(getattr(self.conf, "l2", 0.0) or 0.0)
        acc_dtype = torch.float32
        for k in self.WEIGHT_KEYS:
            if k in params:
                acc_dtype = torch.promote_types(params[k].dtype, torch.float32)
                break
        dev = next(iter(params.values())).device if params else None
        total = torch.zeros((), dtype=acc_dtype, device=dev)
        if l1 == 0.0 and l2 == 0.0:
            return total
        for k in self.WEIGHT_KEYS:
            if k in params and (only is None or k in only) \
                    and k not in exclude:
                w = params[k].to(acc_dtype)
                if l2:
                    total = total + 0.5 * l2 * torch.sum(w * w)
                if l1:
                    total = total + l1 * torch.sum(torch.abs(w))
        return total

    def _dropout(self, x: Tensor, train: bool,
                 gen: Optional[torch.Generator]) -> Tensor:
        """Inverted input dropout (JAX base.py :124): at train time keep
        each unit with probability 1 - p, scaled by 1 / (1 - p)."""
        p = float(getattr(self.conf, "dropout", 0.0) or 0.0)
        if not train or p <= 0.0:
            return x
        if gen is None:
            raise ValueError("dropout requires a generator at train time")
        keep = 1.0 - p
        mask = dropout_mask(x.shape, keep, gen, x.device)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))

    def activation_fn(self):
        from ...ops import activations
        return activations.get(self.conf.activation or "identity")


class BaseRecurrentImpl(LayerImpl):
    """Layers that carry state between calls: the recurrent layers' h (and
    c), the attention layer's KV cache (JAX recurrent.py :31).
    ``forward_with_state(params, x, state0)`` returns (y, state); state0
    None starts from ``init_state``. ``step`` runs one timestep."""

    WEIGHT_KEYS = ("W", "RW")
    # whether truncated BPTT carries this impl's state across windows (true
    # RNN state; the attention KV cache opts out, it is inference-only)
    TBPTT_STATE = True

    def init_state(self, batch: int, dtype=torch.float32,
                   device=torch.device("cpu")) -> dict:
        raise NotImplementedError

    def step(self, params: Params, x_t: Tensor, state: dict
             ) -> Tuple[Tensor, dict]:
        """One timestep for stateful inference."""
        raise NotImplementedError

    def forward(self, params, x, *, train=False, gen=None, mask=None):
        return self.forward_with_state(params, x, None, train=train, gen=gen,
                                       mask=mask)[0]

    def forward_with_state(self, params: Params, x: Tensor, state0, *,
                           train: bool = False,
                           gen: Optional[torch.Generator] = None,
                           mask: Optional[Tensor] = None
                           ) -> Tuple[Tensor, Optional[dict]]:
        raise NotImplementedError

    @staticmethod
    def _mask_carry(new_state: dict, old_state: dict, m_t: Tensor) -> dict:
        """Masked timesteps keep the previous state (variable-length
        sequences): m * new + (1 - m) * old."""
        return {k: m_t * new_state[k] + (1.0 - m_t) * old_state[k]
                for k in new_state}


def materialize_rnn_states(impl_items, existing, batch: int, dtype, device,
                           *, tbptt: bool = False) -> dict:
    """Initial states of the stateful layers (JAX recurrent.py :59): the
    existing entries kept, the rest made with ``init_state``. ``tbptt``
    keeps to the impls whose state truncated BPTT carries across windows:
    the others (the attention KV cache) get the key with None, so every
    window runs them stateless."""
    states = dict(existing or {})
    for key, impl in impl_items:
        if not isinstance(impl, BaseRecurrentImpl):
            continue
        if tbptt and not impl.TBPTT_STATE:
            states.setdefault(key, None)
            continue
        if states.get(key) is None:
            states[key] = impl.init_state(batch, dtype, device)
    return states


def detach_states(states: dict) -> dict:
    """Each state cut from the graph of the window that made it (JAX's
    `stop_gradient` between truncated-BPTT windows); None stays None."""
    return {k: None if v is None else {n: t.detach() for n, t in v.items()}
            for k, v in states.items()}
