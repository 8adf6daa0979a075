"""Model checkpointing — port of deeplearning4j_tpu/util/model_serializer.py.

The zip format is shared with the JAX package:

  - ``configuration.json``: the network config JSON (nn/conf/serde.py);
  - ``coefficients.bin``: npz ``params`` — every parameter flattened in
    the net's `params_flat` order, float32 whatever the parameter dtype
    (a bf16 net's values are exact in f32; on load they are cast back to
    the parameter dtype, as the JAX package does);
  - ``updater.bin``: npz ``state`` — the updater state flattened in
    `updater_state_flat` order;
  - ``variables.bin``: npz of the non-trainable variables (the BatchNorm
    running ``mean``/``var``), keyed ``"<layer index>:<name>"`` for a
    MultiLayerNetwork and ``"<vertex name>:<name>"`` for a
    ComputationGraph (JAX :51-56); written only when some layer has
    variables. bf16
    variables are written as f32 (exact), which the JAX package reads back
    into its bf16 slots; the JAX package writes them as ml_dtypes bf16,
    which an npz holds as raw 2-byte records, read here as bf16 bits;
  - ``meta.json``: step counter, model type, format version.

A zip written by the JAX package's `write_model` restores here, and one
written here restores in the JAX package, for MultiLayerNetworks and
ComputationGraphs, updater state included, so training resumes where
it stopped on either side.

`params_from_jax` carries a JAX net's ``params`` (as numpy) into the
port's layout, which is the same layout: it only changes the array type;
`variables_from_jax` does the same for its ``variables`` (a
MultiLayerNetwork's list, a ComputationGraph's {vertex: {name: array}}).
A restore fills the variables in place.
"""
from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

from ..nn.precision import host_array
from ..nn.step_graph import copy_into
from ..util.device import DeviceLike

CONFIG_JSON = "configuration.json"
COEFFICIENTS_BIN = "coefficients.bin"
UPDATER_BIN = "updater.bin"
VARIABLES_BIN = "variables.bin"
META_JSON = "meta.json"


def _save_npz(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _load_npz(data: bytes) -> dict:
    return dict(np.load(io.BytesIO(data), allow_pickle=False))


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr, copy=True)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16, which torch lacks
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr)


def _variable(arr, dtype) -> torch.Tensor:
    """A ``variables.bin`` array as a tensor of the slot's ``dtype``: raw
    2-byte records (a JAX bf16 array saved by numpy) are bf16 bits."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(dtype)
    return _tensor(arr).to(dtype)


def _tensors(lp) -> Dict[str, torch.Tensor]:
    return {name: _tensor(arr) for name, arr in lp.items()}


def params_from_jax(params):
    """A JAX net's ``params`` (arrays converted with ``np.asarray``; bf16
    arrays become bf16 tensors) as CPU tensors in the port's layout: a
    ComputationGraph's {layer: {name: array}} gives {layer: {name:
    tensor}}, a MultiLayerNetwork's list of per-layer dicts a list. Load
    them with the net's ``set_params``, which places them on its
    device."""
    if isinstance(params, dict):
        return {layer: _tensors(lp) for layer, lp in params.items()}
    return [_tensors(lp) for lp in params]


def variables_from_jax(variables):
    """A JAX net's non-trainable ``variables`` (the BatchNorm running
    statistics) as CPU tensors in the port's layout, as `params_from_jax`
    does for params. A ComputationGraph loads them with
    ``set_variables``; a MultiLayerNetwork's list copies into
    ``net.variables`` (`step_graph.copy_into`)."""
    return params_from_jax(variables)


def _variable_items(net):
    """(key prefix, {name: tensor}) of every layer with variables."""
    v = getattr(net, "variables", [])
    return [(str(k), lv) for k, lv in
            (v.items() if isinstance(v, dict) else enumerate(v)) if lv]


def write_model(net, path: Union[str, Path],
                save_updater: bool = True) -> None:
    """Serialize a MultiLayerNetwork or a ComputationGraph (config,
    params, updater state unless ``save_updater`` is False, variables,
    step) to a zip the JAX package can read."""
    net._check_init()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(CONFIG_JSON, net.conf.to_json())
        zf.writestr(COEFFICIENTS_BIN,
                    _save_npz({"params": net.params_flat().astype(np.float32)}))
        if save_updater:
            zf.writestr(UPDATER_BIN, _save_npz(
                {"state": net.updater_state_flat().astype(np.float32)}))
        var_arrays = {f"{i}:{name}": host_array(arr)
                      for i, lv in _variable_items(net)
                      for name, arr in lv.items()}
        if var_arrays:
            zf.writestr(VARIABLES_BIN, _save_npz(var_arrays))
        zf.writestr(META_JSON, json.dumps({
            "step": net.step,
            "model_type": type(net).__name__,
            "format_version": 1,
        }))


def _restore_variables(net, data: bytes, is_graph: bool) -> None:
    """``variables.bin`` into the net's variable tensors, in place."""
    for key, arr in _load_npz(data).items():
        i, name = key.rsplit(":", 1)
        slot = net.variables[i if is_graph else int(i)]
        if name not in slot:
            raise ValueError(f"variables.bin: {key} has no slot in the net")
        copy_into(slot[name], _variable(arr, slot[name].dtype))


def _restore_state(net, zf: zipfile.ZipFile, load_updater: bool = True
                   ) -> None:
    """A model zip's params, updater state (unless ``load_updater`` is
    False), variables and step into ``net``, in place (JAX
    `_restore_state`; the state tracker restores into a live net)."""
    names = set(zf.namelist())
    net.set_params_flat(_load_npz(zf.read(COEFFICIENTS_BIN))["params"])
    if load_updater and UPDATER_BIN in names:
        net.set_updater_state_flat(_load_npz(zf.read(UPDATER_BIN))["state"])
    if VARIABLES_BIN in names:
        _restore_variables(net, zf.read(VARIABLES_BIN),
                           hasattr(net.conf, "vertices"))
    if META_JSON in names:
        net.step = json.loads(zf.read(META_JSON).decode()).get("step", 0)


def restore_computation_graph(path: Union[str, Path], *,
                              device: DeviceLike = "cuda",
                              load_updater: bool = True):
    """Restore a ComputationGraph zip onto ``device``: params, updater
    state (unless ``load_updater`` is False), variables, step."""
    from ..nn.conf.graph import ComputationGraphConfiguration
    from ..nn.graph import ComputationGraph

    with zipfile.ZipFile(Path(path), "r") as zf:
        conf = ComputationGraphConfiguration.from_json(
            zf.read(CONFIG_JSON).decode())
        net = ComputationGraph(conf, device=device).init()
        _restore_state(net, zf, load_updater)
    return net


def restore_multi_layer_network(path: Union[str, Path], *,
                                device: DeviceLike = "cuda",
                                load_updater: bool = True):
    """Restore a MultiLayerNetwork zip onto ``device``: params, updater
    state (unless ``load_updater`` is False), BatchNorm variables, step."""
    from ..nn.conf.config import MultiLayerConfiguration
    from ..nn.multilayer import MultiLayerNetwork

    with zipfile.ZipFile(Path(path), "r") as zf:
        conf = MultiLayerConfiguration.from_json(
            zf.read(CONFIG_JSON).decode())
        net = MultiLayerNetwork(conf, device=device).init()
        _restore_state(net, zf, load_updater)
    return net


def restore_model(path: Union[str, Path], *, device: DeviceLike = "cuda",
                  load_updater: bool = True):
    """Type-dispatching restore on the zip's ``model_type`` stamp (a zip
    without one is a MultiLayerNetwork, as in the JAX package). A
    quantized artifact (one holding ``quantization.json``) restores as its
    int8 program through `nn.quantization.load_quantized`, as the JAX
    CLI's ``serve --int8`` loads it."""
    with zipfile.ZipFile(Path(path), "r") as zf:
        names = set(zf.namelist())
        model_type = "MultiLayerNetwork"
        if "quantization.json" in names:
            from ..nn.quantization import load_quantized
            return load_quantized(path, device=device)
        if META_JSON in names:
            model_type = json.loads(zf.read(META_JSON).decode()).get(
                "model_type", model_type)
    if model_type == "ComputationGraph":
        return restore_computation_graph(path, device=device,
                                         load_updater=load_updater)
    return restore_multi_layer_network(path, device=device,
                                       load_updater=load_updater)


# the JAX package's aliases of the reference API's names
save_model = write_model
load_model = restore_multi_layer_network
