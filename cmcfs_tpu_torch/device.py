"""Explicit device selection: the port never picks the CPU on its own."""
from __future__ import annotations

import torch


def get_device(name: str | torch.device = "cuda") -> torch.device:
    """``torch.device(name)``; raises ``RuntimeError`` when CUDA is asked
    for and absent.  CPU runs must pass ``"cpu"`` explicitly."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False "
            f"(torch {torch.__version__}, CUDA build {torch.version.cuda})")
    return dev
