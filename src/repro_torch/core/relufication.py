"""Sparsifiable activations (paper §II): the counterpart of
``repro/core/relufication.py`` for the activations SparseInfer predicts."""
from __future__ import annotations

from functools import partial

import torch


def fatrelu(x: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """FATReLU: zero below a positive threshold, identity above."""
    return torch.where(x > threshold, x, torch.zeros_like(x))


def get_activation(name: str, fatrelu_threshold: float = 0.0):
    if name == "fatrelu":
        return partial(fatrelu, threshold=fatrelu_threshold)
    if name == "relu":
        return torch.relu
    raise ValueError(f"activation {name!r} is not ported (relu, fatrelu)")


#: Activations whose post-activation zeros SparseInfer can predict by sign.
SPARSIFIABLE = ("relu", "fatrelu")


def is_sparsifiable(name: str) -> bool:
    return name in SPARSIFIABLE
