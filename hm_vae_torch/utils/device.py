"""The port's device rule: entry points run on ``cuda`` unless the caller asks
for the CPU, and never fall back to the CPU on their own."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
