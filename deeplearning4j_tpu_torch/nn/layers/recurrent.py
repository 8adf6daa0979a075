"""Recurrent layer impls: LSTM, GravesLSTM (peepholes), the bidirectional
GravesLSTM and GRU — port of deeplearning4j_tpu/nn/layers/recurrent.py.

Layout [batch, time, features]. The input projection of every timestep is
one [B*T, n_in] x [n_in, kH] product ahead of the time loop, which then
carries only the [B, H] x [H, kH] recurrent product. An unmasked LSTM
sequence goes through the `lstm_sequence` seam (ops/helpers.py; its
default is a Python loop over T, the port of JAX's `lax.scan`); a masked
one through the per-step `_gates`, where a masked step keeps the previous
state and outputs zeros. The backward pass is autograd through the loop
(no library RNN: cuDNN's LSTM has no peepholes and packs its gates
otherwise). Gate packing is the JAX package's, so parameters carry over
as they are: LSTM [i, f, o, g], GRU [r, z, h~].
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .base import BaseRecurrentImpl, register_impl
from .. import weights as winit
from ...ops import helpers as ophelpers

Tensor = torch.Tensor
State = Dict[str, Tensor]


def _init_gate_weights(gen, conf, n_gates: int, dtype, device,
                       forget_slot: Optional[int] = None):
    """W [n_in, kH], RW [H, kH] and b [kH] (JAX recurrent.py :83); the
    forget gate's slice of b starts at ``forget_gate_bias_init``."""
    dist = conf.dist.spec() if getattr(conf, "dist", None) is not None \
        else None
    H = conf.n_out
    scheme = conf.weight_init or winit.XAVIER
    W = winit.init_weights(gen, (conf.n_in, n_gates * H), scheme, dtype,
                           device, distribution=dist)
    RW = winit.init_weights(gen, (H, n_gates * H), scheme, dtype, device,
                            distribution=dist)
    b = torch.full((n_gates * H,), float(conf.bias_init or 0.0), dtype=dtype,
                   device=device)
    if forget_slot is not None:
        fb = float(getattr(conf, "forget_gate_bias_init", 1.0))
        b[forget_slot * H:(forget_slot + 1) * H] = fb
    return W, RW, b


def _project(params, x):
    """x W + b for all timesteps as one product, time first: [T, B, kH]."""
    B, T, F = x.shape
    xproj = (x.reshape(B * T, F) @ params["W"]).reshape(B, T, -1) \
        + params["b"]
    return xproj.transpose(0, 1)


def _time_mask(mask, x):
    """[B, T] mask -> [T, B, 1] in x's dtype, or None."""
    return None if mask is None else \
        mask.to(x.dtype).transpose(0, 1)[..., None]


class _LSTMCore(BaseRecurrentImpl):
    """Shared LSTM machinery; gate packing [i, f, o, g]."""

    PEEPHOLE = False

    def init_params(self, gen, dtype=torch.float32,
                    device=torch.device("cpu")):
        W, RW, b = _init_gate_weights(gen, self.conf, 4, dtype, device,
                                      forget_slot=1)
        params = {"W": W, "RW": RW, "b": b}
        if self.PEEPHOLE:
            H = self.conf.n_out
            for k in ("pI", "pF", "pO"):
                params[k] = torch.zeros((H,), dtype=dtype, device=device)
        return params

    def init_state(self, batch, dtype=torch.float32,
                   device=torch.device("cpu")):
        H = self.conf.n_out
        return {"h": torch.zeros((batch, H), dtype=dtype, device=device),
                "c": torch.zeros((batch, H), dtype=dtype, device=device)}

    def _gates(self, params, xproj_t, state):
        """One step from xproj_t [B, 4H] (x W + b) and state {h, c}; the
        cell math is ops/helpers.lstm_cell."""
        z = xproj_t + state["h"] @ params["RW"]
        peep = ((params["pI"], params["pF"], params["pO"]) if self.PEEPHOLE
                else (0.0, 0.0, 0.0))
        h, c = ophelpers.lstm_cell(z, state["c"], peep, self.activation_fn())
        return h, {"h": h, "c": c}

    def step(self, params, x_t, state):
        return self._gates(params, x_t @ params["W"] + params["b"], state)

    def forward_with_state(self, params, x, state0, *, train=False, gen=None,
                           mask=None, reverse=False):
        x = self._dropout(x, train, gen)
        B = x.shape[0]
        if state0 is None:
            state0 = self.init_state(B, x.dtype, x.device)
        xproj_t = _project(params, x)
        mask_t = _time_mask(mask, x)
        if mask_t is None:
            H = self.conf.n_out
            peep = (torch.stack([params["pI"], params["pF"], params["pO"]])
                    if self.PEEPHOLE
                    else torch.zeros((3, H), dtype=x.dtype, device=x.device))
            ys, ht, ct = ophelpers.lstm_sequence(
                xproj_t, params["RW"], peep, state0["h"], state0["c"],
                activation=self.conf.activation or "identity",
                reverse=reverse)
            return ys.transpose(0, 1), {"h": ht, "c": ct}
        T = xproj_t.shape[0]
        state, ys = state0, [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            m = mask_t[t]
            h, new_state = self._gates(params, xproj_t[t], state)
            state = self._mask_carry(new_state, state, m)
            ys[t] = h * m
        return torch.stack(ys, dim=1), state


@register_impl("LSTM")
class LSTMImpl(_LSTMCore):
    PEEPHOLE = False


@register_impl("GravesLSTM")
class GravesLSTMImpl(_LSTMCore):
    PEEPHOLE = True


@register_impl("GravesBidirectionalLSTM")
class GravesBidirectionalLSTMImpl(BaseRecurrentImpl):
    """A forward and a backward GravesLSTM over the same input, their
    outputs summed; the state returned is the forward direction's.
    Stepping is refused: a bidirectional output needs the whole
    sequence."""

    WEIGHT_KEYS = ("fwd_W", "fwd_RW", "bwd_W", "bwd_RW")

    def __init__(self, conf):
        super().__init__(conf)
        self._cell = GravesLSTMImpl(conf)

    def init_params(self, gen, dtype=torch.float32,
                    device=torch.device("cpu")):
        out = {f"fwd_{k}": v for k, v in
               self._cell.init_params(gen, dtype, device).items()}
        out.update({f"bwd_{k}": v for k, v in
                    self._cell.init_params(gen, dtype, device).items()})
        return out

    def init_state(self, batch, dtype=torch.float32,
                   device=torch.device("cpu")):
        return self._cell.init_state(batch, dtype, device)

    def forward_with_state(self, params, x, state0, *, train=False, gen=None,
                           mask=None):
        fwd = {k[4:]: v for k, v in params.items() if k.startswith("fwd_")}
        bwd = {k[4:]: v for k, v in params.items() if k.startswith("bwd_")}
        yf, sf = self._cell.forward_with_state(fwd, x, None, train=train,
                                               gen=gen, mask=mask)
        yb, _ = self._cell.forward_with_state(bwd, x, None, train=train,
                                              gen=gen, mask=mask,
                                              reverse=True)
        return yf + yb, sf

    def step(self, params, x_t, state):
        raise NotImplementedError(
            "rnn_time_step is not supported for a bidirectional LSTM")


@register_impl("GRU")
class GRUImpl(BaseRecurrentImpl):
    """Gated recurrent unit: gate packing [r, z, h~];
    h_t = z * h_{t-1} + (1 - z) * h~."""

    def init_params(self, gen, dtype=torch.float32,
                    device=torch.device("cpu")):
        W, RW, b = _init_gate_weights(gen, self.conf, 3, dtype, device)
        return {"W": W, "RW": RW, "b": b}

    def init_state(self, batch, dtype=torch.float32,
                   device=torch.device("cpu")):
        return {"h": torch.zeros((batch, self.conf.n_out), dtype=dtype,
                                 device=device)}

    def _gates(self, params, xproj_t, state):
        H = self.conf.n_out
        act = self.activation_fn()
        h_prev = state["h"]
        RW = params["RW"]
        rz = xproj_t[:, :2 * H] + h_prev @ RW[:, :2 * H]
        r = torch.sigmoid(rz[:, :H])
        z = torch.sigmoid(rz[:, H:])
        hc = act(xproj_t[:, 2 * H:] + (r * h_prev) @ RW[:, 2 * H:])
        h = z * h_prev + (1.0 - z) * hc
        return h, {"h": h}

    def step(self, params, x_t, state):
        return self._gates(params, x_t @ params["W"] + params["b"], state)

    def forward_with_state(self, params, x, state0, *, train=False, gen=None,
                           mask=None):
        x = self._dropout(x, train, gen)
        if state0 is None:
            state0 = self.init_state(x.shape[0], x.dtype, x.device)
        xproj_t = _project(params, x)
        mask_t = _time_mask(mask, x)
        state, ys = state0, []
        for t in range(xproj_t.shape[0]):
            h, new_state = self._gates(params, xproj_t[t], state)
            if mask_t is not None:
                new_state = self._mask_carry(new_state, state, mask_t[t])
                h = h * mask_t[t]
            state = new_state
            ys.append(h)
        return torch.stack(ys, dim=1), state
