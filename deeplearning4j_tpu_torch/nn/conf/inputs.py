"""Input type descriptors — the port's own copy of the feed-forward and
recurrent types of deeplearning4j_tpu/nn/conf/inputs.py (same classes,
fields and layouts), so a graph config that records its input types
reads in the port. Layouts: feed-forward [batch, size]; recurrent
[batch, time, size]. The convolutional types come with the training
slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .serde import register


@dataclass
class InputType:
    kind: str = "feedforward"


@register
@dataclass
class FeedForwardInputType(InputType):
    kind: str = "feedforward"
    size: int = 0


@register
@dataclass
class RecurrentInputType(InputType):
    kind: str = "recurrent"
    size: int = 0
    timesteps: Optional[int] = None
