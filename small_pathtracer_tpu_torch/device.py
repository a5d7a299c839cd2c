"""Device resolution for the port's entry points.

Public constructors default to ``"cuda"``: the port runs on the card unless
the caller asks for the CPU. A CUDA device without CUDA raises; nothing
falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a torch.device; raises RuntimeError naming CUDA when a
    CUDA device is asked for and CUDA is absent, ValueError for any device
    other than cuda or cpu."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available "
            "(pass device='cpu' for the eager path)"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
