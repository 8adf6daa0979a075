"""Model checkpointing — port of deeplearning4j_tpu/util/model_serializer.py.

The zip format is shared with the JAX package:

  - ``configuration.json``: the network config JSON (nn/conf/serde.py);
  - ``coefficients.bin``: npz ``params`` — every parameter flattened in
    the net's `params_flat` order, float32;
  - ``updater.bin``: npz ``state`` — the updater state flattened in
    `updater_state_flat` order (MultiLayerNetwork zips);
  - ``variables.bin``: npz of the non-trainable variables (the BatchNorm
    running ``mean``/``var``), keyed ``"<layer index>:<name>"``;
  - ``meta.json``: step counter, model type, format version.

A zip written by the JAX package's `write_model` restores here, and one
written here restores in the JAX package, for MultiLayerNetworks and
ComputationGraphs. A ComputationGraph zip written here holds no
``updater.bin``: the port's graph serves and keeps no updater state.

`params_from_jax` carries a JAX net's ``params`` (as numpy) into the
port's layout, which is the same layout: it only changes the array type.
"""
from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

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


def _tensors(lp) -> Dict[str, torch.Tensor]:
    return {name: torch.from_numpy(np.array(arr, copy=True))
            for name, arr in lp.items()}


def params_from_jax(params):
    """A JAX net's ``params`` (arrays converted with ``np.asarray``) as CPU
    tensors in the port's layout: a ComputationGraph's {layer: {name:
    array}} gives {layer: {name: tensor}}, a MultiLayerNetwork's list of
    per-layer dicts a list. Load them with the net's ``set_params``,
    which places them on its device."""
    if isinstance(params, dict):
        return {layer: _tensors(lp) for layer, lp in params.items()}
    return [_tensors(lp) for lp in params]


def write_model(net, path: Union[str, Path]) -> None:
    """Serialize a MultiLayerNetwork (config, params, updater state,
    variables) or a ComputationGraph (config, params) to a zip the JAX
    package can read."""
    net._check_init()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(CONFIG_JSON, net.conf.to_json())
        zf.writestr(COEFFICIENTS_BIN,
                    _save_npz({"params": net.params_flat().astype(np.float32)}))
        if hasattr(net, "updater_state_flat"):
            zf.writestr(UPDATER_BIN, _save_npz(
                {"state": net.updater_state_flat().astype(np.float32)}))
        var_arrays = {f"{i}:{name}": arr.detach().cpu().numpy()
                      for i, lv in enumerate(getattr(net, "variables", []))
                      for name, arr in lv.items()}
        if var_arrays:
            zf.writestr(VARIABLES_BIN, _save_npz(var_arrays))
        zf.writestr(META_JSON, json.dumps({
            "step": net.step,
            "model_type": type(net).__name__,
            "format_version": 1,
        }))


def restore_computation_graph(path: Union[str, Path], *,
                              device: DeviceLike = "cuda"):
    """Restore a ComputationGraph zip onto ``device``."""
    from ..nn.conf.graph import ComputationGraphConfiguration
    from ..nn.graph import ComputationGraph

    with zipfile.ZipFile(Path(path), "r") as zf:
        names = set(zf.namelist())
        conf = ComputationGraphConfiguration.from_json(
            zf.read(CONFIG_JSON).decode())
        net = ComputationGraph(conf, device=device).init()
        net.set_params_flat(_load_npz(zf.read(COEFFICIENTS_BIN))["params"])
        if VARIABLES_BIN in names:
            raise NotImplementedError(
                "ComputationGraphs with non-trainable variables (BatchNorm) "
                "come with the ComputationGraph training slice")
        if META_JSON in names:
            net.step = json.loads(zf.read(META_JSON).decode()).get("step", 0)
    return net


def restore_multi_layer_network(path: Union[str, Path], *,
                                device: DeviceLike = "cuda",
                                load_updater: bool = True):
    """Restore a MultiLayerNetwork zip onto ``device``: params, updater
    state (unless ``load_updater`` is False), BatchNorm variables, step."""
    from ..nn.conf.config import MultiLayerConfiguration
    from ..nn.multilayer import MultiLayerNetwork

    with zipfile.ZipFile(Path(path), "r") as zf:
        names = set(zf.namelist())
        conf = MultiLayerConfiguration.from_json(
            zf.read(CONFIG_JSON).decode())
        net = MultiLayerNetwork(conf, device=device).init()
        net.set_params_flat(_load_npz(zf.read(COEFFICIENTS_BIN))["params"])
        if load_updater and UPDATER_BIN in names:
            net.set_updater_state_flat(
                _load_npz(zf.read(UPDATER_BIN))["state"])
        if VARIABLES_BIN in names:
            for key, arr in _load_npz(zf.read(VARIABLES_BIN)).items():
                i, name = key.rsplit(":", 1)
                slot = net.variables[int(i)]
                dtype = slot[name].dtype if name in slot else None
                slot[name] = torch.as_tensor(arr).to(device=net.device,
                                                     dtype=dtype)
        if META_JSON in names:
            net.step = json.loads(zf.read(META_JSON).decode()).get("step", 0)
    return net


def restore_model(path: Union[str, Path], *, device: DeviceLike = "cuda"):
    """Type-dispatching restore on the zip's ``model_type`` stamp (a zip
    without one is a MultiLayerNetwork, as in the JAX package)."""
    with zipfile.ZipFile(Path(path), "r") as zf:
        model_type = "MultiLayerNetwork"
        if META_JSON in set(zf.namelist()):
            model_type = json.loads(zf.read(META_JSON).decode()).get(
                "model_type", model_type)
    if model_type == "ComputationGraph":
        return restore_computation_graph(path, device=device)
    return restore_multi_layer_network(path, device=device)
