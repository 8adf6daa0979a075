"""Model checkpointing — port of deeplearning4j_tpu/util/model_serializer.py.

The zip format is shared with the JAX package:

  - ``configuration.json``: the graph config JSON (nn/conf/serde.py);
  - ``coefficients.bin``: npz ``params`` — every parameter flattened in
    `ComputationGraph.params_flat` order, float32;
  - ``meta.json``: step counter, model type, format version.

A zip written by the JAX package's `write_model` restores here, and one
written here restores in the JAX package (which then has no
``updater.bin``: this slice serves and keeps no updater state).

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
VARIABLES_BIN = "variables.bin"
META_JSON = "meta.json"


def _save_npz(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _load_npz(data: bytes) -> dict:
    return dict(np.load(io.BytesIO(data), allow_pickle=False))


def params_from_jax(params: Dict[str, Dict[str, np.ndarray]]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX net's ``params`` ({layer: {name: array}}, arrays converted
    with ``np.asarray``) as CPU tensors in the port's layout — load them
    with `ComputationGraph.set_params`, which places them on the graph's
    device."""
    return {layer: {name: torch.from_numpy(np.array(arr, copy=True))
                    for name, arr in lp.items()}
            for layer, lp in params.items()}


def write_model(net, path: Union[str, Path]) -> None:
    """Serialize a ComputationGraph to a zip the JAX package can read."""
    net._check_init()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(CONFIG_JSON, net.conf.to_json())
        zf.writestr(COEFFICIENTS_BIN,
                    _save_npz({"params": net.params_flat().astype(np.float32)}))
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
                "models with non-trainable variables (BatchNorm) come with "
                "the training slice")
        if META_JSON in names:
            net.step = json.loads(zf.read(META_JSON).decode()).get("step", 0)
    return net


def restore_model(path: Union[str, Path], *, device: DeviceLike = "cuda"):
    """Type-dispatching restore on the zip's ``model_type`` stamp. This
    slice restores ComputationGraphs; a MultiLayerNetwork zip raises."""
    with zipfile.ZipFile(Path(path), "r") as zf:
        model_type = "MultiLayerNetwork"
        if META_JSON in set(zf.namelist()):
            model_type = json.loads(zf.read(META_JSON).decode()).get(
                "model_type", model_type)
    if model_type == "ComputationGraph":
        return restore_computation_graph(path, device=device)
    raise NotImplementedError(
        f"model_type {model_type!r}: the port restores ComputationGraph "
        "zips; MultiLayerNetwork comes with the training slice")
