"""Device choice shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU.

    Without a GPU, ``None`` raises: the port never drops quietly to the
    CPU.  The CPU is used only when the caller names it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:  # "cuda" -> "cuda:<current>"
        device = torch.device("cuda", torch.cuda.current_device())
    return device
