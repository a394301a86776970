"""Capacity-bounded neuron-group selection: the counterpart of
``repro/core/selection.py``.

Groups are ranked by predictor margin (most active first) and the top ``C``
survive.  Ties are the norm (at alpha=1 margins are integers), so the order
must match the reference's ``lax.top_k``, which keeps the lower index among
equal values: a stable ascending sort does, ``torch.topk`` promises no tie
order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Selection(NamedTuple):
    """Fixed-shape selection of surviving groups (leading dims ``...``:
    one independent selection each)."""

    indices: torch.Tensor  # (..., C) int32 — padded past `count` with 0
    valid: torch.Tensor    # (..., C) bool
    count: torch.Tensor    # (...) int32


class SelectionStats(NamedTuple):
    """Telemetry of one capacity selection (each of shape ``...``)."""

    predicted: torch.Tensor  # int32 — entries the predictor keeps
    selected: torch.Tensor   # int32 — survivors after the capacity clamp
    overflow: torch.Tensor   # int32 — predicted entries the clamp dropped
    occupancy: torch.Tensor  # float32 — selected / capacity


def capacity_select(margin: torch.Tensor, capacity: int) -> Selection:
    """Top-``capacity`` smallest margins of ``margin`` (..., k) along the
    last axis, valid entries compacted to the front (stable), padding
    re-pointed at index 0."""
    capacity = min(capacity, margin.shape[-1])
    idx = torch.sort(margin, dim=-1, stable=True).indices[..., :capacity]
    valid = margin.gather(-1, idx) <= 0
    count = valid.sum(-1, dtype=torch.int32)
    order = torch.sort((~valid).to(torch.int8), dim=-1, stable=True).indices
    idx, valid = idx.gather(-1, order), valid.gather(-1, order)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    return Selection(idx.to(torch.int32), valid, count)


def capacity_select_with_stats(margin: torch.Tensor, capacity: int
                               ) -> tuple[Selection, SelectionStats]:
    """:func:`capacity_select` plus its overflow/occupancy telemetry."""
    sel = capacity_select(margin, capacity)
    cap_eff = min(capacity, margin.shape[-1])
    predicted = (margin <= 0).sum(-1, dtype=torch.int32)
    occupancy = sel.count.to(torch.float32) / float(cap_eff)
    return sel, SelectionStats(predicted, sel.count, predicted - sel.count,
                               occupancy)


def clamp_selection(sel: Selection, stats: SelectionStats, capacity
                    ) -> tuple[Selection, SelectionStats]:
    """Clamp a Selection and its stats to a smaller effective capacity.

    :func:`capacity_select` orders survivors margin-ascending with the valid
    entries a contiguous prefix, so keeping the first ``capacity`` entries
    equals selecting with that capacity directly.  The shape stays at the
    wide ``len(sel.indices)``; clamped-off entries are re-pointed at group 0
    and marked invalid, like capacity padding.  The sharded strategies
    clamp each shard to its entry of ``shard_bucket_caps`` with it
    (``runtime/distributed.py``)."""
    cap_max = sel.indices.shape[-1]
    dev = sel.indices.device
    cap = torch.as_tensor(capacity, dtype=torch.int32, device=dev)
    keep = torch.arange(cap_max, dtype=torch.int32, device=dev) < cap
    valid = sel.valid & keep
    count = torch.minimum(sel.count, cap)
    idx = torch.where(valid, sel.indices, torch.zeros_like(sel.indices))
    occupancy = count.to(torch.float32) / torch.clamp(
        cap.to(torch.float32), min=1.0)
    return (Selection(idx.to(torch.int32), valid, count),
            SelectionStats(stats.predicted, count, stats.predicted - count,
                           occupancy))


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


def take_row_groups(w_grouped: torch.Tensor,
                    indices: torch.Tensor) -> torch.Tensor:
    """Selected row groups of a grouped weight matrix: w_grouped
    (n_groups, G, d), indices (..., C) group ids (padding already re-pointed
    at a valid group) -> (..., C, G, d)."""
    return w_grouped[indices.long()]


def mask_from_selection(sel: Selection, k: int) -> torch.Tensor:
    """Boolean keep-mask (..., k) of a Selection's valid entries.  A sum,
    not an assignment: padding points at index 0 too, and must not clear a
    selected group 0 (no boolean indexing, so no host sync on the card)."""
    hits = torch.zeros(sel.indices.shape[:-1] + (k,), dtype=torch.int32,
                       device=sel.indices.device)
    return hits.scatter_add_(-1, sel.indices.long(),
                             sel.valid.to(torch.int32)) > 0


def actual_sparsity_mask(h1: torch.Tensor,
                         threshold: float = 0.0) -> torch.Tensor:
    """The paper's +AS mask (§IV, actual sparsity): the exact zeros after
    the gate projection.  h1: post-activation gate values; returns the
    keep-mask of the same shape, True where the neuron is live."""
    return h1 > threshold


def expected_capacity(k: int, sparsity: float, slack: float = 1.3,
                      multiple: int = 128) -> int:
    """Default capacity: expected density with slack, rounded up to a
    multiple of ``multiple`` and capped at ``k``."""
    dense = max(1, int(round(k * (1.0 - sparsity) * slack)))
    cap = int(math.ceil(dense / multiple) * multiple)
    return min(cap, k)
