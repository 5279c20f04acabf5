"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to
``"cuda"``.  The CPU runs only when the caller asks for it: a missing
card raises instead of quietly running somewhere else.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
