"""Post-training int8 quantization for inference — a port of
deeplearning4j_tpu/nn/quantization.py.

  - ``fold_batchnorm``: an inference-mode BatchNorm folded into the
    identity-activation Convolution or Dense before it (float-exact up to
    associativity), in float64 on the host as the JAX package folds it.
  - ``quantize(net, calib_batches)`` (`MultiLayerNetwork`): per-output-
    channel symmetric int8 weights, per-tensor activation scales from the
    calibration data (max |x| over it), biases kept in f32. Each
    quantized layer runs

        x_q = clip(round(x / s_x), -127, 127)        int8
        acc = x_q @ W_q  (a conv: im2col, then the same product)  int32
        y   = act(acc * (s_x * s_w[out]) + b)        f32, then act dtype

    and every other layer runs its float forward (`QuantizedNetwork`).
  - ``quantize_graph(net, calib_batches)`` (`ComputationGraph`): the
    Dense and Convolution vertices quantized the same way, no BN folding;
    the result is an inference-only clone of the graph whose other
    vertices (attention, LayerNorm, the RnnOutput head) run their float
    forward, with its own streaming state, so the decode engine serves it
    as it serves the float graph.
  - ``save_quantized`` / ``save_quantized_graph`` / ``load_quantized``:
    the float model zip plus ``quantization.json`` (the activation scales,
    the fold flag and the activation dtype); weight quantization is
    rebuilt from the float params at load. The layout is the JAX
    package's: either package reads what the other wrote.

The int8 product is exact: s8 x s8 summed in int32 (`int8_matmul`, through
``torch._int_mm``), so the accumulator equals the JAX package's bit for
bit, and the f32 epilogue runs its operations in the same order. On the
card ``torch._int_mm`` wants more than 16 rows and K, N multiples of 8:
the weights are zero-padded once, the rows and K of each input per call
(zeros add nothing to the sums). There is no float fallback: a product
that cannot run raises.
"""
from __future__ import annotations

import json
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda_kernels import conv2d_ref, conv_geometry
from .conf.preprocessors import (CnnToRnnPreProcessor,
                                 FeedForwardToRnnPreProcessor)
from .layers.convolution import ConvolutionLayerImpl, _padding_config
from .layers.feedforward import DenseLayerImpl, OutputLayerImpl
from .layers.normalization import BatchNormalizationImpl
from .precision import cast_floats, host_array

__all__ = ["QuantizedNetwork", "fold_batchnorm", "int8_matmul",
           "load_quantized", "quantize", "quantize_graph", "save_quantized",
           "save_quantized_graph"]

Tensor = torch.Tensor

_EPS = 1e-12

QUANT_JSON = "quantization.json"

# activation dtypes an artifact can name
_ACT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
               "float64": torch.float64}
_ACT_NAMES = {v: k for k, v in _ACT_DTYPES.items()}


def _np64(a) -> np.ndarray:
    return np.asarray(host_array(a) if isinstance(a, Tensor) else a,
                      np.float64)


def _bn_scale_shift(bn_impl, params, variables
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel (scale, shift) of an inference-mode BatchNorm, y = scale
    * x + shift (JAX :58), in float64."""
    conf = bn_impl.conf
    mean = _np64(variables["mean"])
    var = _np64(variables["var"])
    if conf.lock_gamma_beta:
        gamma = np.full_like(mean, float(conf.gamma))
        beta = np.full_like(mean, float(conf.beta))
    else:
        gamma = _np64(params["gamma"])
        beta = _np64(params["beta"])
    scale = gamma / np.sqrt(var + float(conf.eps))
    return scale, beta - mean * scale


def fold_batchnorm(W, b, scale: np.ndarray, shift: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """BN(conv(x)) = conv'(x): W' = W * scale[out], b' = b * scale + shift
    (JAX :75), in float64."""
    W, b = _np64(W), _np64(b)
    return W * scale.reshape((1,) * (W.ndim - 1) + (-1,)), b * scale + shift


def _weight_qparams(W: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 quantization of W [..., out] (JAX
    :86): (int8 W, f32 scales)."""
    maxabs = np.max(np.abs(W), axis=tuple(range(W.ndim - 1)))
    s = np.maximum(maxabs, _EPS) / 127.0
    Wq = np.clip(np.round(W / s), -127, 127).astype(np.int8)
    return Wq, s.astype(np.float32)


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _product_weight(Wq: np.ndarray, device: torch.device) -> Tensor:
    """The int8 weight as the [K, N] operand of `int8_matmul` on
    ``device``: on the card zero-padded to K, N multiples of 8."""
    w = torch.from_numpy(np.ascontiguousarray(
        Wq.reshape(-1, Wq.shape[-1]))).to(device)
    if device.type == "cuda":
        K, N = w.shape
        w = F.pad(w, (0, _round8(N) - N, 0, _round8(K) - K)).contiguous()
    return w


def int8_matmul(a: Tensor, w: Tensor, n: int) -> Tensor:
    """The exact product of int8 ``a`` [M, K] and the `_product_weight`
    ``w`` [K', N'], summed in int32: [M, n]. On the card the rows are
    padded past 16 to a multiple of 8 and K to w's (``torch._int_mm``'s
    shape rule); a product it refuses raises."""
    M, K = a.shape
    if a.device.type == "cuda":
        Kp = w.shape[0]
        Mp = max(24, _round8(M))
        if (Mp, Kp) != (M, K):
            a = F.pad(a, (0, Kp - K, 0, Mp - M))
        return torch._int_mm(a.contiguous(), w)[:M, :n]
    return torch._int_mm(a.contiguous(), w)[:, :n]


def _im2col(x: Tensor, kh: int, kw: int, stride, padding, dilation
            ) -> Tensor:
    """[B, OH, OW, kh * kw * C] windows of an NHWC ``x`` (any dtype), in
    the HWIO weight's (i, j, c) order, zero-padded as `conv_geometry`
    pads: the conv as one product."""
    B, H, W, C = x.shape
    oh, ow, pads = conv_geometry(H, W, kh, kw, stride, padding, dilation)
    xp = F.pad(x, (0, 0, pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    sh, sw = stride
    dh, dw = dilation
    cols = [xp[:, i * dh:i * dh + (oh - 1) * sh + 1:sh,
               j * dw:j * dw + (ow - 1) * sw + 1:sw, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1)


def _int8_forward(kind: str, w: Tensor, n_out: int, w_scale: Tensor,
                  bias: Tensor, x_scale: Tensor, conv_args: dict,
                  activation, act_dtype, x: Tensor) -> Tensor:
    """THE int8 inference step of both facades (JAX :94): per-tensor input
    quantization, the exact s8 x s8 -> s32 product, the f32 epilogue
    ``acc * (x_scale * w_scale) + bias``, the activation, the cast to the
    activation dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    xq = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
    if kind == "conv":
        xq = _im2col(xq, conv_args["kh"], conv_args["kw"],
                     conv_args["stride"], conv_args["padding"],
                     conv_args["dilation"])
    lead = xq.shape[:-1]
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), w, n_out)
    acc = acc.reshape(*lead, n_out)
    y = acc.to(torch.float32) * (x_scale * w_scale) + bias
    return activation(y).to(act_dtype)


def _conv_args(conf) -> dict:
    kh, kw = conf.kernel_size
    return dict(kh=kh, kw=kw, stride=tuple(conf.stride),
                padding=_padding_config(conf),
                dilation=tuple(conf.dilation))


class _QStep:
    """One plan step (JAX :116). kind: 'dense' | 'conv' | 'float'."""

    def __init__(self, kind: str, index: int, impl=None, consumed: int = 1,
                 activation=None, conv_args: Optional[dict] = None):
        self.kind = kind
        self.index = index        # first source-layer index this step covers
        self.impl = impl          # the float impl (kind == 'float')
        self.consumed = consumed  # source layers consumed (2: BN folded)
        self.activation = activation
        self.conv_args = conv_args or {}
        self.Wf: Optional[np.ndarray] = None  # folded float64 weights
        self.bf: Optional[np.ndarray] = None
        self.Wq: Optional[np.ndarray] = None
        self.w_scale: Optional[np.ndarray] = None
        self.x_scale: float = 0.0
        self.x_maxabs: float = 0.0


def _build_steps(net, fold_bn: bool) -> List[_QStep]:
    """The plan of a MultiLayerNetwork (JAX :214): a Dense, Output or
    Convolution layer is a quantized step, folding the inference-mode BN
    right after it when its activation is the identity and no
    preprocessor sits at the BN's index; every other layer a float step."""
    impls = net._impls
    steps: List[_QStep] = []
    i = 0
    while i < len(impls):
        impl = impls[i]
        kind = ("conv" if isinstance(impl, ConvolutionLayerImpl)
                else "dense" if type(impl) in (DenseLayerImpl,
                                               OutputLayerImpl)
                else None)
        if kind is None:
            steps.append(_QStep("float", i, impl=impl))
            i += 1
            continue
        conf = impl.conf
        Wf, bf = _np64(net.params[i]["W"]), _np64(net.params[i]["b"])
        act_impl, consumed = impl, 1
        if (fold_bn and (conf.activation or "identity") in ("identity",
                                                             "linear")
                and i + 1 < len(impls)
                and isinstance(impls[i + 1], BatchNormalizationImpl)
                and net.conf.preprocessor(i + 1) is None):
            scale, shift = _bn_scale_shift(impls[i + 1], net.params[i + 1],
                                           net.variables[i + 1])
            Wf, bf = fold_batchnorm(Wf, bf, scale, shift)
            act_impl, consumed = impls[i + 1], 2
        st = _QStep(kind, i, consumed=consumed,
                    activation=act_impl.activation_fn(),
                    conv_args=_conv_args(conf) if kind == "conv" else None)
        st.Wf, st.bf = Wf, bf
        steps.append(st)
        i += consumed
    return steps


def _walk_plan(net, steps, params, variables, x: Tensor, act_dtype,
               qstep_fn, fmask=None) -> Tensor:
    """THE plan walk of calibration and quantized inference (JAX :276):
    input adaptation, preprocessors, float layers through the impls, and
    ``qstep_fn(si, step, cur)`` for each quantized step. ``fmask`` goes
    to every step whose input keeps a time axis."""
    conf = net.conf
    cur = net._adapt_input(x)
    if cur.is_floating_point():
        cur = cur.to(act_dtype)
    timesteps = cur.shape[1] if cur.ndim == 3 else 1
    for si, st in enumerate(steps):
        proc = conf.preprocessor(st.index)
        if proc is not None:
            if isinstance(proc, (FeedForwardToRnnPreProcessor,
                                 CnnToRnnPreProcessor)):
                cur = proc.preprocess_with_time(cur, timesteps)
            else:
                cur = proc.preprocess(cur)
        if cur.ndim == 3:
            timesteps = cur.shape[1]
        lmask = fmask if cur.ndim == 3 else None
        if st.kind == "float":
            # the params at the activation dtype for the math, the output
            # back at it: f32 masters must not creep a bf16 plan to f32
            p = cast_floats([params[st.index]], act_dtype)[0]
            cur, _ = st.impl.forward_with_variables(
                p, cur, variables[st.index], train=False, mask=lmask)
            if cur.is_floating_point() and cur.dtype != act_dtype:
                cur = cur.to(act_dtype)
        else:
            cur = qstep_fn(si, st, cur)
            if lmask is not None and cur.ndim == 3:
                # the int8 step bypasses the impl's own mask application
                cur = cur * lmask[..., None].to(cur.dtype)
    return cur


def _calibrate(net, steps: List[_QStep], calib_batches) -> None:
    """The float plan over the calibration set in f32, recording each
    quantized step's input max |x| (JAX :318)."""
    dev = net.device

    def qstep(si, st, cur):
        st.x_maxabs = max(st.x_maxabs, float(cur.abs().max()))
        W = torch.as_tensor(st.Wf, dtype=torch.float32, device=dev)
        b = torch.as_tensor(st.bf, dtype=torch.float32, device=dev)
        if st.kind == "dense":
            return st.activation(cur @ W + b)
        a = st.conv_args
        return st.activation(conv2d_ref(
            cur, W, stride=a["stride"], padding=a["padding"],
            dilation=a["dilation"]) + b)

    with torch.no_grad():
        for batch in calib_batches:
            x = getattr(batch, "features", batch)
            x = torch.as_tensor(np.asarray(x, np.float32)
                                if not isinstance(x, Tensor) else x,
                                dtype=torch.float32, device=dev)
            _walk_plan(net, steps, net.params, net.variables, x,
                       torch.float32, qstep)


def _finalize_steps(steps: List[_QStep]) -> None:
    for st in steps:
        if st.kind in ("dense", "conv"):
            st.Wq, st.w_scale = _weight_qparams(st.Wf)
            st.x_scale = max(st.x_maxabs, _EPS) / 127.0


class QuantizedNetwork:
    """The inference-only int8 view of a trained MultiLayerNetwork (JAX
    :135), built by :func:`quantize` or :func:`load_quantized`.
    ``output``/``predict``/``evaluate`` mirror the float net's inference
    API; ``_consts[si]`` holds a quantized step's (int8 W, w scales, f32
    bias, x scale) on the net's device."""

    def __init__(self, net, steps: List[_QStep], act_dtype=torch.float32):
        self._net = net
        self._steps = steps
        self._act_dtype = act_dtype
        self.conf = net.conf
        dev = net.device
        self._consts: Dict[int, Tuple[Tensor, Tensor, Tensor, Tensor]] = {}
        self._w: Dict[int, Tensor] = {}
        for si, st in enumerate(steps):
            if st.kind in ("dense", "conv"):
                self._consts[si] = (
                    torch.from_numpy(st.Wq).to(dev),
                    torch.as_tensor(st.w_scale, dtype=torch.float32,
                                    device=dev),
                    torch.as_tensor(np.asarray(st.bf, np.float32),
                                    device=dev),
                    torch.tensor(st.x_scale, dtype=torch.float32,
                                 device=dev))
                self._w[si] = _product_weight(st.Wq, dev)

    def num_params(self) -> int:
        """The logical parameter count of the float model."""
        return self._net.num_params()

    def param_bytes(self) -> int:
        total = 0
        for si, st in enumerate(self._steps):
            if si in self._consts:
                Wq, sw, b, _ = self._consts[si]
                total += Wq.numel() + sw.numel() * 4 + b.numel() * 4
            elif st.impl is not None:
                total += sum(p.numel() * p.element_size()
                             for p in self._net.params[st.index].values())
        return total

    def float_param_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for lp in self._net.params for p in lp.values())

    def _run(self, x: Tensor, fmask=None) -> Tensor:
        def qstep(si, st, cur):
            _, sw, b, sx = self._consts[si]
            return _int8_forward(st.kind, self._w[si], st.Wq.shape[-1], sw, b,
                                 sx, st.conv_args, st.activation,
                                 self._act_dtype, cur)
        return _walk_plan(self._net, self._steps, self._net.params,
                          self._net.variables, x, self._act_dtype, qstep,
                          fmask=fmask)

    @torch.no_grad()
    def output(self, x, fmask=None) -> Tensor:
        net = self._net
        return self._run(net._as_tensor(x), fmask=net._as_tensor(fmask))

    def predict(self, x) -> np.ndarray:
        return self.output(x).argmax(dim=-1).cpu().numpy()

    def evaluate(self, iterator, top_n: int = 1):
        """Classification metrics over a dataset iterator, with the float
        facade's mask contract (JAX :195)."""
        from ..evaluation.evaluation import Evaluation
        ev = Evaluation(top_n=top_n)
        for ds in iterator:
            out = self.output(ds.features,
                              fmask=getattr(ds, "features_mask", None))
            ev.eval(ds.labels, host_array(out),
                    mask=getattr(ds, "labels_mask", None))
        return ev


def quantize(net, calib_batches: Sequence[Any], *, fold_bn: bool = True,
             act_dtype=None) -> QuantizedNetwork:
    """Post-training int8 quantization of a trained MultiLayerNetwork (JAX
    :603). ``calib_batches``: DataSets or raw feature arrays, run once in
    float for the activation scales. ``act_dtype``: the dtype activations
    travel in between steps (default the net's compute dtype)."""
    net._check_init()
    if act_dtype is None:
        act_dtype = net.compute_dtype
    steps = _build_steps(net, fold_bn)
    calib = list(calib_batches)
    if not calib:
        raise ValueError("quantize() needs at least one calibration batch")
    _calibrate(net, steps, calib)
    _finalize_steps(steps)
    return QuantizedNetwork(net, steps, act_dtype=act_dtype)


class _QuantizedVertexImpl:
    """The int8 shim of one ComputationGraph vertex (JAX :329): it takes
    the vertex's place in the clone's ``_impls``, so the graph's own
    forward runs it like any layer, ignoring the float params it is
    handed; the rest of the layer surface delegates to the float impl.
    A train-mode forward raises: the clone is inference-only."""

    def __init__(self, float_impl, kind, Wq: np.ndarray, w_scale, bias,
                 x_scale: float, conv_args, act_dtype, device):
        self._float_impl = float_impl
        self.conf = float_impl.conf
        self.WEIGHT_KEYS = float_impl.WEIGHT_KEYS
        self.kind = kind
        self.Wq = torch.from_numpy(Wq).to(device)
        self._w = _product_weight(Wq, device)
        self.n_out = int(Wq.shape[-1])
        self.w_scale = torch.as_tensor(w_scale, dtype=torch.float32,
                                       device=device)
        self.bias = torch.as_tensor(np.asarray(bias, np.float32),
                                    device=device)
        self.x_scale = torch.tensor(x_scale, dtype=torch.float32,
                                    device=device)
        self.activation = float_impl.activation_fn()
        self.conv_args = conv_args or {}
        self.act_dtype = act_dtype

    def reg_loss(self, params):
        return self._float_impl.reg_loss(params)

    def activation_fn(self):
        return self.activation

    def forward(self, params, x, *, train=False, gen=None, mask=None):
        if train:
            raise RuntimeError(
                "quantize_graph() produces an inference-only network; "
                "train on the float ComputationGraph and re-quantize")
        return _int8_forward(self.kind, self._w, self.n_out, self.w_scale,
                             self.bias, self.x_scale, self.conv_args,
                             self.activation, self.act_dtype, x)

    def forward_with_variables(self, params, x, variables, *, train=False,
                               gen=None, mask=None):
        return self.forward(params, x, train=train, gen=gen,
                            mask=mask), variables


def _graph_quant_targets(net) -> Dict[str, str]:
    """vertex name -> 'conv' | 'dense' of every quantizable vertex (JAX
    :432): the one selection rule of `quantize_graph` and the loader."""
    targets: Dict[str, str] = {}
    for name, impl in net._impls.items():
        if isinstance(impl, ConvolutionLayerImpl):
            targets[name] = "conv"
        elif type(impl) in (DenseLayerImpl, OutputLayerImpl):
            targets[name] = "dense"
    return targets


def _build_graph_clone(net, x_scales: Dict[str, float], act_dtype):
    """The inference-only quantized clone of a float graph from per-vertex
    activation scales (JAX :446): fresh or from an artifact, the weights
    quantized from the float params either way. The clone shares the
    float params and conf, and keeps its own streaming state."""
    targets = _graph_quant_targets(net)
    qimpls = {}
    for name, sx in x_scales.items():
        kind = targets[name]
        p = net.params[name]
        Wq, w_scale = _weight_qparams(_np64(p["W"]))
        impl = net._impls[name]
        qimpls[name] = _QuantizedVertexImpl(
            impl, kind, Wq, w_scale, host_array(p["b"]), float(sx),
            _conv_args(impl.conf) if kind == "conv" else None, act_dtype,
            net.device)
    clone = object.__new__(type(net))
    clone.__dict__.update(net.__dict__)
    clone._impls = {**net._impls, **qimpls}
    clone._rnn_state = {}
    clone._quantized_vertices = sorted(qimpls)
    clone._quant_act_dtype = act_dtype
    return clone


def quantize_graph(net, calib_batches: Sequence[Any], *, act_dtype=None):
    """Post-training int8 quantization of a trained ComputationGraph (JAX
    :379): the Dense and Convolution vertices (a Dense-type output head
    included) go int8; attention, LayerNorm, element-wise and RnnOutput
    vertices run their float forward. No BN folding. ``calib_batches``:
    (Multi)DataSets or raw input arrays (single-input graphs). Returns the
    inference-only clone."""
    net._check_init()
    if act_dtype is None:
        act_dtype = net.compute_dtype
    conf = net.conf
    targets = _graph_quant_targets(net)
    calib = list(calib_batches)
    if not calib:
        raise ValueError("quantize_graph() needs at least one calibration "
                         "batch")
    maxabs = {name: 0.0 for name in targets}
    with torch.no_grad():
        for batch in calib:
            if hasattr(batch, "features_list"):
                inputs = batch.features_list
            elif hasattr(batch, "features"):
                inputs = [batch.features]
            else:
                inputs = [batch]
            ins = [torch.as_tensor(np.asarray(a, np.float32),
                                   device=net.device) for a in inputs]
            acts, _ = net._forward_impl(net.params, ins)
            for name in targets:
                x = acts[conf.vertex_inputs[name][0]]
                maxabs[name] = max(maxabs[name], float(x.abs().max()))
    x_scales = {name: max(maxabs[name], _EPS) / 127.0 for name in targets}
    return _build_graph_clone(net, x_scales, act_dtype)


def _dtype_name(dt) -> str:
    name = _ACT_NAMES.get(dt)
    if name is None:
        raise ValueError(f"act_dtype {dt} cannot be persisted (supported: "
                         f"{sorted(_ACT_DTYPES)}): refusing to write an "
                         "unloadable artifact")
    return name


def _append_meta(path, meta: dict) -> None:
    with zipfile.ZipFile(path, "a", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(QUANT_JSON, json.dumps(meta))


def save_quantized(qnet: QuantizedNetwork, path) -> None:
    """The float model zip plus ``quantization.json`` (JAX :490): the
    per-step activation scales, the fold flag and the activation dtype.
    The artifact stays a float checkpoint too."""
    from ..util.model_serializer import write_model
    name = _dtype_name(qnet._act_dtype)
    write_model(qnet._net, path)
    _append_meta(path, {
        "facade": "multilayer",
        "fold_bn": any(s.consumed == 2 for s in qnet._steps),
        "act_dtype": name,
        "x_scales": {str(si): float(st.x_scale)
                     for si, st in enumerate(qnet._steps)
                     if st.kind in ("dense", "conv")}})


def save_quantized_graph(qgraph, path) -> None:
    """A `quantize_graph` clone's float graph zip plus
    ``quantization.json`` with the per-vertex activation scales (JAX
    :521); ``serve --int8 --generate`` serves it through the decode
    engine."""
    from ..util.model_serializer import write_model
    names = getattr(qgraph, "_quantized_vertices", None)
    if not names:
        raise ValueError("save_quantized_graph() wants a quantize_graph() "
                         "clone (no quantized vertices found)")
    name = _dtype_name(getattr(qgraph, "_quant_act_dtype", torch.float32))
    write_model(qgraph, path)
    _append_meta(path, {
        "facade": "graph", "act_dtype": name,
        "x_scales": {n: float(qgraph._impls[n].x_scale) for n in names}})


def is_quantized_artifact(path) -> bool:
    """Whether the zip at ``path`` carries ``quantization.json``."""
    with zipfile.ZipFile(path) as zf:
        return QUANT_JSON in zf.namelist()


def load_quantized(path, *, device="cuda"):
    """Reload a quantized artifact onto ``device`` (JAX :570): a
    `save_quantized` zip as a :class:`QuantizedNetwork`, a
    `save_quantized_graph` zip as the int8 graph clone; the float net is
    restored, the plan rebuilt and the saved activation scales installed
    verbatim (no calibration data needed)."""
    from ..util.model_serializer import (restore_computation_graph,
                                         restore_multi_layer_network)
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read(QUANT_JSON).decode())
    act_dtype = _ACT_DTYPES.get(meta.get("act_dtype"))
    if act_dtype is None:
        raise ValueError(f"unsupported act_dtype '{meta.get('act_dtype')}'")
    if meta.get("facade") == "graph":
        net = restore_computation_graph(path, device=device)
        x_scales = {str(k): float(v) for k, v in meta["x_scales"].items()}
        want = set(_graph_quant_targets(net))
        if set(x_scales) != want:
            raise ValueError("quantization plan mismatch: saved scales "
                             f"cover vertices {sorted(x_scales)} but the "
                             f"restored graph quantizes {sorted(want)}")
        return _build_graph_clone(net, x_scales, act_dtype)
    if meta.get("facade") != "multilayer":
        raise ValueError(f"not a quantized artifact: {meta}")
    net = restore_multi_layer_network(path, device=device)
    steps = _build_steps(net, bool(meta["fold_bn"]))
    scales = meta["x_scales"]
    want = {si for si, st in enumerate(steps) if st.kind in ("dense", "conv")}
    if set(map(int, scales)) != want:
        raise ValueError("quantization plan mismatch: saved scales cover "
                         f"steps {sorted(scales)} but the restored net "
                         f"quantizes steps {sorted(want)}")
    _finalize_steps(steps)
    for si, st in enumerate(steps):
        if st.kind in ("dense", "conv"):
            st.x_scale = float(scales[str(si)])  # verbatim
    return QuantizedNetwork(net, steps, act_dtype=act_dtype)
