"""Polymorphic config serialization: configs are *data*.

The port's own copy of deeplearning4j_tpu/nn/conf/serde.py (that module
imports no JAX, but the port imports nothing of the JAX package). The
``@class`` names and field names of the port's config dataclasses match
the JAX package's, so a ``configuration.json`` written by either
package reads in the other.

Any registered dataclass serializes to a dict with an ``@class``
discriminator, recursively; JSON and YAML entry points. YAML is the JAX
package's: ``yaml.safe_dump`` of the same dict with sorted keys, PyYAML
imported only when YAML is asked for, so YAML written by either package
loads in the other to the same ``to_json()``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Type

_REGISTRY: Dict[str, Type] = {}


def register(cls):
    """Class decorator: make a dataclass JSON/YAML round-trippable."""
    _REGISTRY[cls.__name__] = cls
    return cls


def to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        d: Dict[str, Any] = {"@class": type(obj).__name__}
        for f in dataclasses.fields(obj):
            d[f.name] = to_dict(getattr(obj, f.name))
        return d
    if isinstance(obj, tuple):
        return [to_dict(o) for o in obj]
    if isinstance(obj, list):
        return [to_dict(o) for o in obj]
    if isinstance(obj, dict):
        return {str(k): to_dict(v) for k, v in obj.items()}
    return obj


def from_dict(d: Any) -> Any:
    if isinstance(d, dict) and "@class" in d:
        name = d["@class"]
        if name not in _REGISTRY:
            raise ValueError(f"Unknown config class '{name}' (not registered)")
        cls = _REGISTRY[name]
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: from_dict(v) for k, v in d.items() if k != "@class" and k in field_names}
        return cls(**kwargs)
    if isinstance(d, list):
        return [from_dict(x) for x in d]
    if isinstance(d, dict):
        return {k: from_dict(v) for k, v in d.items()}
    return d


def to_json(obj: Any, indent: int = 2) -> str:
    return json.dumps(to_dict(obj), indent=indent, sort_keys=True)


def from_json(s: str) -> Any:
    return from_dict(json.loads(s))


def to_yaml(obj: Any) -> str:
    import yaml

    return yaml.safe_dump(to_dict(obj), sort_keys=True)


def from_yaml(s: str) -> Any:
    import yaml

    return from_dict(yaml.safe_load(s))
