"""Distributed configuration registry (ZooKeeper analog) — port of
deeplearning4j_tpu/parallel/registry.py (:23-86).

Capability parity with `deeplearning4j-scaleout-zookeeper`
(ZooKeeperConfigurationRegister.java / ZooKeeperConfigurationRetriever.java:
serialize a configuration under a known key so every worker in the cluster
retrieves the identical bytes).

Substrate: a cluster's hosts share storage (NFS, GCS fuse) rather than a
ZK ensemble, so the registry is a directory of atomically-written JSON
entries, in the JAX package's format (a key either package registers, the
other retrieves) — same contract (last write wins, readers never observe torn
values, keys enumerable), no coordination service to operate. Values are
either raw JSON strings or objects exposing to_json() (the config classes).
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Union


class ConfigurationRegistry:
    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        if "/" in key or key.startswith("."):
            raise ValueError(f"invalid registry key {key!r}")
        return self.root / f"{key}.json"

    def register(self, key: str, conf) -> None:
        """Store a configuration under `key` (reference
        ZooKeeperConfigurationRegister.register()). Atomic: readers see the
        old or the new value, never a torn write."""
        if hasattr(conf, "to_json"):
            payload = {"type": type(conf).__name__, "json": conf.to_json()}
        else:
            payload = {"type": "raw", "json": json.dumps(conf)}
        payload["registered_at"] = time.time()
        path = self._path(key)
        tmp = path.with_name(f".{path.name}.tmp")
        tmp.write_text(json.dumps(payload))
        with open(tmp, "rb") as fh:
            os.fsync(fh.fileno())
        os.replace(tmp, path)

    def retrieve_json(self, key: str) -> Optional[str]:
        """Raw serialized form (reference retriever returns the bytes)."""
        path = self._path(key)
        if not path.exists():
            return None
        return json.loads(path.read_text())["json"]

    def retrieve(self, key: str):
        """Deserialize through the config serde registry when the stored
        type is a known configuration class; raw JSON values decode to
        Python objects."""
        path = self._path(key)
        if not path.exists():
            return None
        payload = json.loads(path.read_text())
        tname, blob = payload["type"], payload["json"]
        if tname == "raw":
            return json.loads(blob)
        from ..nn.conf.config import (MultiLayerConfiguration,
                                      NeuralNetConfiguration)
        from ..nn.conf.graph import ComputationGraphConfiguration
        for cls in (MultiLayerConfiguration, ComputationGraphConfiguration,
                    NeuralNetConfiguration):
            if cls.__name__ == tname:
                return cls.from_json(blob)
        return json.loads(blob)

    def keys(self) -> List[str]:
        return sorted(p.stem for p in self.root.glob("*.json")
                      if not p.name.startswith("."))

    def delete(self, key: str) -> bool:
        path = self._path(key)
        try:
            path.unlink()
            return True
        except FileNotFoundError:
            return False
