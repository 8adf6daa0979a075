"""Device resolution shared by every entry point of the port.

The port runs on the card unless the caller asks for the CPU: an entry
point given ``device="cuda"`` (the default everywhere) on a machine
without a CUDA device raises instead of quietly moving to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a `torch.device`; raises for a CUDA device that is
    not present and for device types the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is "
                "present; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} "
                         "(the port runs on 'cuda' or 'cpu')")
    return dev
