"""ComputationGraph: DAG network runtime — port of deeplearning4j_tpu/nn/graph.py.

This slice covers inference: ``init`` (seeded `torch.Generator`),
``_forward_impl`` with explicit per-layer states (the decode engine's
entry), ``output``, and ``params_flat``/``set_params_flat`` in the JAX
flat order (layers by sorted name, then params by sorted name), which
is the order of the model zip's ``coefficients.bin``. Training comes
with a later slice.

Parameters live on ``device`` (default "cuda"; it raises when no CUDA
device is present — pass device="cpu" to run on the CPU).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .conf.graph import (ComputationGraphConfiguration, ElementWiseVertex,
                         GraphVertex, LayerVertex)
from .layers.base import BaseRecurrentImpl, LayerImpl, impl_for
# importing the impl modules registers them
from .layers import attention as _attention  # noqa: F401
from .layers import feedforward as _feedforward  # noqa: F401
from .layers import normalization as _normalization  # noqa: F401
from ..util.device import DeviceLike, resolve_device

Tensor = torch.Tensor
_DTYPES = {"float32": torch.float32}


def _dtype_of(conf) -> torch.dtype:
    if conf.compute_dtype not in (None, conf.dtype):
        raise NotImplementedError("mixed precision comes with the training "
                                  "slice")
    try:
        return _DTYPES[conf.dtype]
    except KeyError:
        raise NotImplementedError(
            f"dtype {conf.dtype!r}: the port serves float32 models "
            "(the paged-decode kernel is f32, as in the JAX package)"
        ) from None


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration, *,
                 device: DeviceLike = "cuda"):
        self.conf = conf
        self.device = resolve_device(device)
        self.dtype = _dtype_of(conf.conf)
        self.topo = conf.topological_order()
        self._impls: Dict[str, LayerImpl] = {}
        for name, v in conf.vertices.items():
            if isinstance(v, LayerVertex):
                if v.preprocessor is not None:
                    raise NotImplementedError(
                        "vertex preprocessors come with a later slice")
                self._impls[name] = impl_for(v.layer)
        self.params: Dict[str, Dict[str, Tensor]] = {}
        self.step = 0
        self._initialized = False

    # -- init ------------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None
             ) -> "ComputationGraph":
        """Draw every layer's params, in sorted layer-name order, from
        ``generator`` (default: a CPU generator seeded with the config's
        seed), then place them on the graph's device."""
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(int(self.conf.conf.seed))
        for name in sorted(self._impls):
            self.params[name] = self._impls[name].init_params(
                gen, self.dtype, self.device)
        self._initialized = True
        return self

    def _check_init(self):
        if not self._initialized:
            self.init()

    # -- forward ---------------------------------------------------------------
    def _vertex_forward(self, name: str, vertex: GraphVertex,
                        inputs: List[Tensor], params, *, states, new_states):
        if isinstance(vertex, LayerVertex):
            impl = self._impls[name]
            if isinstance(impl, BaseRecurrentImpl):
                y, st = impl.forward_with_state(
                    params[name], inputs[0], (states or {}).get(name))
                new_states[name] = st
                return y
            return impl.forward(params[name], inputs[0])
        if isinstance(vertex, ElementWiseVertex):
            op = vertex.op.lower()
            out = inputs[0]
            if op == "add":
                for a in inputs[1:]:
                    out = out + a
            elif op == "subtract":
                for a in inputs[1:]:
                    out = out - a
            elif op in ("product", "multiply"):
                for a in inputs[1:]:
                    out = out * a
            elif op in ("average", "avg"):
                out = sum(inputs) / float(len(inputs))
            elif op == "max":
                for a in inputs[1:]:
                    out = torch.maximum(out, a)
            else:
                raise ValueError(f"Unknown elementwise op '{vertex.op}'")
            return out
        raise NotImplementedError(
            f"vertex type {type(vertex).__name__} comes with a later slice")

    def _forward_impl(self, params, inputs: Sequence[Tensor], *,
                      states: Optional[Dict[str, Any]] = None):
        """Topo-ordered DAG forward with explicit states (JAX graph.py:173).
        Returns (dict name -> activation, new states of the stateful
        layers)."""
        conf = self.conf
        acts: Dict[str, Tensor] = {}
        for i, iname in enumerate(conf.network_inputs):
            x = inputs[i]
            if x.is_floating_point() and x.dtype != self.dtype:
                x = x.to(self.dtype)
            acts[iname] = x
        new_states: Dict[str, Any] = {}
        for name in self.topo:
            vin = [acts[src] for src in conf.vertex_inputs[name]]
            acts[name] = self._vertex_forward(
                name, conf.vertices[name], vin, params, states=states,
                new_states=new_states)
        return acts, new_states

    @torch.inference_mode()
    def output(self, *inputs) -> List[Tensor]:
        """Full-sequence forward of host or device inputs ([B, T, F]); the
        network outputs, on the graph's device."""
        self._check_init()
        ins = [torch.as_tensor(np.asarray(a) if not isinstance(a, Tensor)
                               else a).to(self.device) for a in inputs]
        acts, _ = self._forward_impl(self.params, ins)
        return [acts[name] for name in self.conf.network_outputs]

    # -- params ----------------------------------------------------------------
    def num_params(self) -> int:
        return int(sum(p.numel() for lp in self.params.values()
                       for p in lp.values()))

    def params_flat(self) -> np.ndarray:
        chunks = []
        for name in sorted(self.params):
            for pname in sorted(self.params[name]):
                chunks.append(self.params[name][pname].detach().cpu()
                              .numpy().reshape(-1))
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def set_params_flat(self, flat: np.ndarray):
        flat = np.asarray(flat)
        total = sum(p.numel() for lp in self.params.values()
                    for p in lp.values())
        if flat.size != total:
            raise ValueError(f"flat params hold {flat.size} values, the "
                             f"graph has {total}")
        off = 0
        for name in sorted(self.params):
            for pname in sorted(self.params[name]):
                arr = self.params[name][pname]
                n = arr.numel()
                self.params[name][pname] = torch.as_tensor(
                    flat[off:off + n].reshape(tuple(arr.shape))).to(
                    device=self.device, dtype=arr.dtype)
                off += n

    def set_params(self, params: Dict[str, Dict[str, Tensor]]):
        """Replace the params with ``params`` (same names and shapes),
        copied onto the graph's device — e.g. from
        `util.model_serializer.params_from_jax`."""
        self._check_init()
        if set(params) != set(self.params):
            raise ValueError(f"layer names differ: {sorted(params)} vs "
                             f"{sorted(self.params)}")
        new = {}
        for name, lp in self.params.items():
            if set(params[name]) != set(lp):
                raise ValueError(f"{name}: param names differ")
            new[name] = {}
            for pname, cur in lp.items():
                t = torch.as_tensor(params[name][pname])
                if tuple(t.shape) != tuple(cur.shape):
                    raise ValueError(f"{name}.{pname}: shape "
                                     f"{tuple(t.shape)} vs {tuple(cur.shape)}")
                new[name][pname] = t.to(device=self.device, dtype=cur.dtype)
        self.params = new
