"""Capacity-bounded neuron-group selection: the counterpart of
``repro/core/selection.py``.

Groups are ranked by predictor margin (most active first) and the top ``C``
survive.  Ties are the norm (at alpha=1 margins are integers), so the order
must match the reference's ``lax.top_k``, which keeps the lower index among
equal values: a stable ascending sort does, ``torch.topk`` promises no tie
order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Selection(NamedTuple):
    """Fixed-shape selection of surviving groups."""

    indices: torch.Tensor  # (C,) int32 — padded past `count` with 0
    valid: torch.Tensor    # (C,) bool
    count: torch.Tensor    # () int32


class SelectionStats(NamedTuple):
    """Telemetry of one capacity selection (all 0-d tensors)."""

    predicted: torch.Tensor  # int32 — entries the predictor keeps
    selected: torch.Tensor   # int32 — survivors after the capacity clamp
    overflow: torch.Tensor   # int32 — predicted entries the clamp dropped
    occupancy: torch.Tensor  # float32 — selected / capacity


def capacity_select(margin: torch.Tensor, capacity: int) -> Selection:
    """Top-``capacity`` smallest margins of ``margin`` (k,), valid entries
    compacted to the front (stable), padding re-pointed at index 0."""
    capacity = min(capacity, margin.shape[-1])
    idx = torch.sort(margin, stable=True).indices[:capacity]
    valid = margin[idx] <= 0
    count = valid.sum(dtype=torch.int32)
    order = torch.sort((~valid).to(torch.int8), stable=True).indices
    idx, valid = idx[order], valid[order]
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    return Selection(idx.to(torch.int32), valid, count)


def capacity_select_with_stats(margin: torch.Tensor, capacity: int
                               ) -> tuple[Selection, SelectionStats]:
    """:func:`capacity_select` plus its overflow/occupancy telemetry."""
    sel = capacity_select(margin, capacity)
    cap_eff = min(capacity, margin.shape[-1])
    predicted = (margin <= 0).sum(dtype=torch.int32)
    occupancy = sel.count.to(torch.float32) / float(cap_eff)
    return sel, SelectionStats(predicted, sel.count, predicted - sel.count,
                               occupancy)


def group_margins(margin: torch.Tensor, group_size: int) -> torch.Tensor:
    """Per-neuron -> per-group margins (min over the G members)."""
    k = margin.shape[-1]
    if k % group_size:
        raise ValueError(f"k={k} not divisible by group={group_size}")
    return margin.reshape(margin.shape[:-1] + (k // group_size, group_size)
                          ).amin(-1)


def union_margin(margin: torch.Tensor) -> torch.Tensor:
    """Batch union of survive sets: (B, k) -> (k,) by min over tokens."""
    if margin.ndim == 1:
        return margin
    return margin.reshape(-1, margin.shape[-1]).amin(0)
