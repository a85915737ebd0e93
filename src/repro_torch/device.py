"""Device resolution and description for the port's entry points."""
from __future__ import annotations

import shutil
import subprocess
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises.

    The port never carries on quietly on the CPU: the CPU is used only
    when the caller names it, as the tests do.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


def card_label(device: torch.device) -> str:
    """What a measurement ran on: ``cpu``, or the card's name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` reports them."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return f"{torch.cuda.get_device_name(index)}, power limit not read (no nvidia-smi)"
    out = subprocess.run(
        [smi, f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
