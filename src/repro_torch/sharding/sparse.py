"""Shard-grid checks of the tensor-parallel sparse decode: the semantic
half of ``repro/sharding/sparse.py``.

``SparseInferConfig.tp_shards`` (ms) splits the FFN hidden dim k into ms
contiguous row slices, each with its own batch union and top-C/ms
selection; ``dp_shards`` (ds) splits the batch slots into ds blocks, each
with its own unions (``runtime/distributed.py`` runs that grid).  These
checks decide whether a config can run at all: they take the config alone,
since the port runs the grid on one device.  Placing the slices on several
devices (the reference's param specs and ``place_serve_params``) is not
ported.
"""
from __future__ import annotations

import dataclasses


def resolve_grid(sparse, batch: int) -> tuple[int, int]:
    """The semantic (ds, ms) grid of ``sparse`` (1 = an unsharded axis) for
    a batch of ``batch`` slots, which must split evenly over the data
    shards."""
    ds, ms = max(1, sparse.dp_shards or 1), max(1, sparse.tp_shards or 1)
    if batch % ds:
        raise ValueError(
            f"batch {batch} not divisible by dp_shards={ds}: every data "
            "shard owns the same number of batch slots")
    return ds, ms


def validate_shardable(sparse, k: int, ms: int) -> None:
    """Fail fast if ``sparse`` cannot split ``k`` rows ``ms`` ways: every
    shard needs whole row groups, whole int8 quant groups, and every rung
    of the capacity ladder must split evenly over the shards.  ``k`` is
    the sparse MLP layers' width: a moe config with no dense first layer
    has none to check (the server skips it)."""
    if ms <= 1:
        return
    g = sparse.group_size
    if k % (ms * g):
        raise ValueError(
            f"d_ff={k} not divisible by tp_shards={ms} x group_size={g}")
    if getattr(sparse, "weight_dtype", "") == "int8":
        qg = sparse.quant_group_size
        if (k // ms) % qg:
            raise ValueError(
                f"per-shard rows k/ms={k // ms} not divisible by "
                f"quant_group_size={qg}: every shard must own whole wd "
                "quant row groups")
    for capg in sparse.capacity_ladder(k):
        # shard_capacity raises with the offending rung in the message
        dataclasses.replace(sparse, tp_shards=ms,
                            capacity_override=capg).shard_capacity(k)
