"""Where the port's entry points put their tensors."""

from __future__ import annotations

import subprocess
from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when a card is asked for and none is present, so a
    run never carries on on the CPU by accident."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def card_info(device: DeviceLike) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``power_limit`` None where it cannot be read; "cpu" and None on the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device_name": "cpu", "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = ""
    return {"device_name": torch.cuda.get_device_name(dev), "power_limit": smi or None}
