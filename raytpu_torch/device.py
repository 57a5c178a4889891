"""The default-device rule of every entry point: a tensor is made on this
process's card unless the caller names a device, and without a card that
raises (the CPU is never taken in its place; device="cpu" asks for it).
parallel.mesh re-exports local_device."""

from __future__ import annotations

import os

import torch


def local_device() -> torch.device:
    """The card of this process: LOCAL_RANK (torchrun's) modulo the cards
    present.  Raises RuntimeError without a card: the CPU is never taken
    in its place, and a caller that wants it passes device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu'")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def resolve_device(device) -> torch.device:
    """`device`, or this process's card (local_device) when None."""
    return local_device() if device is None else torch.device(device)
