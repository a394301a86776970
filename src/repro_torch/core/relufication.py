"""Activations and ReLUfication (paper §II): the counterpart of
``repro/core/relufication.py``.

SparseInfer targets ReLU-fied LLMs, whose SiLU/GELU gate activations were
swapped for ReLU (or FATReLU) and fine-tuned.  This module holds the
activation registry (the dense MLP of an arch run with sparsity off uses
its own activation) and the config-level swap ``relufy``.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F


def fatrelu(x: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """FATReLU: zero below a positive threshold, identity above."""
    return torch.where(x > threshold, x, torch.zeros_like(x))


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "silu": F.silu,
    # the reference's "gelu" is jax.nn.gelu(approximate=True)
    "gelu": partial(F.gelu, approximate="tanh"),
    "gelu_exact": partial(F.gelu, approximate="none"),
}


def get_activation(name: str, fatrelu_threshold: float = 0.0):
    if name == "fatrelu":
        return partial(fatrelu, threshold=fatrelu_threshold)
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return ACTIVATIONS[name]


#: Activations whose post-activation zeros SparseInfer can predict by sign.
SPARSIFIABLE = ("relu", "fatrelu")


def is_sparsifiable(name: str) -> bool:
    return name in SPARSIFIABLE


def relufy(activation: str) -> str:
    """SiLU/GELU -> ReLU swap (ReLUfication); identity for the sparse
    activations."""
    return activation if activation in SPARSIFIABLE else "relu"
