"""GPipe-style pipeline parallelism over a 'pipe' axis of ranks: the
counterpart of ``repro/sharding/pipeline.py``.

The layer stack splits into S contiguous stages; stage s (the rank at
position s of the mesh's 'pipe' line) holds its layers only
(``stage_params``, ``local_stage``), so the pipeline also splits the
parameter memory.  ``pipeline_apply`` streams M microbatches through the
stages over M + S - 1 ticks: on each tick every stage runs what it holds
and sends the result to the next stage with a point-to-point send (the
reference's ``ppermute``, a ring whose wraparound is ignored); the last
stage's result goes to every rank of the line.

Schedule: GPipe (fill/drain).  With M microbatches over S stages the
bubble fraction is (S - 1) / (M + S - 1); choose M >= 4 S in practice.
As in the reference, the train launcher makes no 'pipe' axis: the module
is its own, held by its test.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def stage_params(params_stacked, n_stages: int):
    """Split (n_layers, ...) stacked layer params into (S, layers/S,
    ...)."""
    def split(a):
        n = a.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             "stages")
        return a.reshape((n_stages, n // n_stages) + tuple(a.shape[1:]))
    return tree_map(split, params_stacked)


def local_stage(staged, mesh, axis: str = "pipe"):
    """This rank's stage (layers/S, ...) of a staged tree: a copy, so the
    other stages can be freed."""
    s = mesh.axis_index(axis)
    return tree_map(lambda a: a[s].clone(), staged)


def pipeline_apply(block_fn: Callable, stage_weights, x: torch.Tensor, *,
                   mesh, n_microbatches: int, axis: str = "pipe"):
    """Run x through all stages with GPipe microbatch streaming.

    ``block_fn(weights_of_stage, x_mb) -> x_mb`` applies ONE stage's
    layers; ``stage_weights`` is this rank's stage (``local_stage``); x is
    the (B, ...) global batch, the same on every rank of the line, with B
    divisible by ``n_microbatches``.  Each rank loops over M + S - 1 ticks:
    stage 0 takes microbatch t while t < M, every stage runs what it
    holds, the last stage keeps finished microbatch t - (S - 1), and every
    stage sends its result to the next.  Returns x after the last stage,
    in the original microbatch order, on every rank."""
    s = mesh.axis_size(axis)
    m = n_microbatches
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    mb = b // m
    rank = mesh.axis_index(axis)
    group = mesh.group(axis) if s > 1 else None
    ranks = dist.get_process_group_ranks(group) if s > 1 else []
    xmb = x.reshape((m, mb) + tuple(x.shape[1:]))
    buf = torch.zeros_like(xmb[0])                   # the in-flight mb
    out = torch.zeros_like(xmb)                      # drained results
    for t in range(m + s - 1):
        if rank == 0 and t < m:
            buf = xmb[t]
        y = block_fn(stage_weights, buf)
        done = t - (s - 1)
        if rank == s - 1 and done >= 0:
            out[done] = y
        buf = _shift(y.contiguous(), ranks, rank, group) if s > 1 else y
    if s > 1:
        dist.broadcast(out, ranks[s - 1], group=group)
    return out.reshape((b,) + tuple(x.shape[1:]))


def _shift(y: torch.Tensor, ranks: list, rank: int, group) -> torch.Tensor:
    """Stage i's ``y`` to stage i + 1 (mod S); what stage i - 1 sent."""
    s = len(ranks)
    got = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y, ranks[(rank + 1) % s], group),
           dist.P2POp(dist.irecv, got, ranks[(rank - 1) % s], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
