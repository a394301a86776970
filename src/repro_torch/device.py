"""Device resolution for the port's entry points.

Entry points default to ``cuda`` and never fall back to the CPU on their
own: without a card the caller must ask for ``device="cpu"`` explicitly.
``device="meta"`` builds shapes and dtypes only (the dry run).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no GPU
    is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` seeded with ``seed`` for draws on ``device``;
    on ``meta``, which has no generator of its own, a CPU one (a draw on
    ``meta`` reads nothing from it)."""
    dev = "cpu" if device.type == "meta" else device
    return torch.Generator(device=dev).manual_seed(seed)
