"""Device selection for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fallback."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises; the CPU
    runs only when it is asked for by name."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "radar_depth_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
