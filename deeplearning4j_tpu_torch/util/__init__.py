"""Utilities: checkpoint serialization and gradient checking (the JAX
package's util/__init__.py exports, for the modules the port has)."""
from .model_serializer import (load_model, restore_computation_graph,
                               restore_model, restore_multi_layer_network,
                               save_model, write_model)
from .gradientcheck import check_gradients

__all__ = [
    "write_model", "save_model", "load_model", "restore_model",
    "restore_multi_layer_network", "restore_computation_graph",
    "check_gradients",
]
