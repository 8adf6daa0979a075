"""Input type descriptors — the port's own copy of
deeplearning4j_tpu/nn/conf/inputs.py (same classes, fields and layouts),
so configs that record their input types read in both packages and drive
the same shape inference. Layouts:

  - feedforward:    [batch, size]
  - recurrent:      [batch, time, size]
  - convolutional:  [batch, height, width, channels]  (NHWC)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .serde import register


@dataclass
class InputType:
    kind: str = "feedforward"

    @staticmethod
    def feed_forward(size: int) -> "FeedForwardInputType":
        return FeedForwardInputType(size=size)

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None
                  ) -> "RecurrentInputType":
        return RecurrentInputType(size=size, timesteps=timesteps)

    @staticmethod
    def convolutional(height: int, width: int, channels: int
                      ) -> "ConvolutionalInputType":
        return ConvolutionalInputType(height=height, width=width,
                                      channels=channels)

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int
                           ) -> "ConvolutionalFlatInputType":
        return ConvolutionalFlatInputType(height=height, width=width,
                                          channels=channels)


@register
@dataclass
class FeedForwardInputType(InputType):
    kind: str = "feedforward"
    size: int = 0

    def flat_size(self) -> int:
        return self.size


@register
@dataclass
class RecurrentInputType(InputType):
    kind: str = "recurrent"
    size: int = 0
    timesteps: Optional[int] = None

    def flat_size(self) -> int:
        return self.size


@register
@dataclass
class ConvolutionalInputType(InputType):
    kind: str = "convolutional"
    height: int = 0
    width: int = 0
    channels: int = 0

    def flat_size(self) -> int:
        return self.height * self.width * self.channels

    def hwc(self) -> Tuple[int, int, int]:
        return (self.height, self.width, self.channels)


@register
@dataclass
class ConvolutionalFlatInputType(InputType):
    """Flattened image input (e.g. raw MNIST rows of 784)."""

    kind: str = "convolutional_flat"
    height: int = 0
    width: int = 0
    channels: int = 1

    def flat_size(self) -> int:
        return self.height * self.width * self.channels
