"""Memory-bounded scans: counterpart of ``repro/layers/scan_utils.py``.

``checkpointed_scan`` is a sqrt-BPTT scan: the time axis is cut in chunks
of about sqrt(T); each chunk runs under ``torch.utils.checkpoint``, so
only the carries at chunk boundaries are kept for the backward pass and
each chunk recomputes its interior.  Recurrent cells with large carries
need it in training (an mLSTM's per-head matrix memory is O(head_dim^2)
a step).  The forward values are the plain loop's, bit for bit; with
autograd off (serving) it is the plain loop.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint


def _index(xs, i: int):
    if isinstance(xs, (tuple, list)):
        return type(xs)(_index(x, i) for x in xs)
    return xs[i]


def _stack(ys: list):
    if isinstance(ys[0], (tuple, list)):
        return type(ys[0])(_stack([y[j] for y in ys])
                           for j in range(len(ys[0])))
    return torch.stack(ys)


def _cat(ys: list):
    if isinstance(ys[0], (tuple, list)):
        return type(ys[0])(_cat([y[j] for y in ys])
                           for j in range(len(ys[0])))
    return torch.cat(ys)


def _first_leaf(xs):
    while isinstance(xs, (tuple, list)):
        xs = xs[0]
    return xs


def scan(step: Callable, carry, xs, lo: int = 0, hi: int | None = None):
    """The plain loop ``carry, y_t = step(carry, xs[t])`` over t in [lo,
    hi).  ``xs``: a tensor or nested tuples of tensors with a leading time
    axis; returns (carry, the y_t stacked along a new leading axis)."""
    hi = _first_leaf(xs).shape[0] if hi is None else hi
    ys = []
    for t in range(lo, hi):
        carry, y = step(carry, _index(xs, t))
        ys.append(y)
    return carry, _stack(ys)


def chunk_size(t: int, chunk: int = 0) -> int:
    """The boundary interval: ``chunk`` (0: floor(sqrt(T))), at most T,
    shrunk to a divisor of T."""
    if chunk <= 0:
        chunk = max(1, int(math.sqrt(t)))
    chunk = min(chunk, t)
    while t % chunk:
        chunk -= 1
    return chunk


def checkpointed_scan(step: Callable, carry, xs, chunk: int = 0):
    """``scan(step, carry, xs)`` with sqrt-BPTT chunk checkpointing."""
    t = _first_leaf(xs).shape[0]
    chunk = chunk_size(t, chunk)
    if t // chunk <= 1 or not torch.is_grad_enabled():
        return scan(step, carry, xs)
    ys = []
    for lo in range(0, t, chunk):
        carry, y = checkpoint(scan, step, carry, xs, lo, lo + chunk,
                              use_reentrant=False)
        ys.append(y)
    return carry, _cat(ys)
