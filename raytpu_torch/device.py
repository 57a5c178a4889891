"""The default-device rule of every entry point: a tensor is made on this
process's card unless the caller names a device, and without a card that
raises (the CPU is never taken in its place; device="cpu" asks for it).
parallel.mesh re-exports local_device.  nvidia_smi_line names the card and
its power limit beside a measurement."""

from __future__ import annotations

import os
import subprocess

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


def nvidia_smi_line(device) -> str:
    """The CUDA `device`'s name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W"), its row found by the card's UUID
    (CUDA_VISIBLE_DEVICES may renumber the cards).  Raises RuntimeError if
    nvidia-smi fails or does not list the device."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=uuid,name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    uuid = str(torch.cuda.get_device_properties(device).uuid).lower()
    for row in res.stdout.strip().splitlines():
        card, line = row.split(",", 1)
        if card.strip().lower().removeprefix("gpu-") == uuid.removeprefix("gpu-"):
            return line.strip()
    raise RuntimeError(f"nvidia-smi lists no card of UUID {uuid}: {res.stdout}")
