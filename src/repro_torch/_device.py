"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no CUDA device, a CUDA ask (by default or by name)
    raises — an entry point never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device available for device={device!r}; pass "
            f"device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        # name the device the tensors will report ("cuda:0", not "cuda")
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_name(dev: torch.device) -> str:
    """What ran: the card's name, or the host's CPU."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type.upper()

