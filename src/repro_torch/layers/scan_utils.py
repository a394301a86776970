"""Memory-bounded scans: counterpart of ``repro/layers/scan_utils.py``.

``checkpointed_scan`` is a sqrt-BPTT scan: the time axis is cut in chunks
of about sqrt(T); each chunk runs under ``torch.utils.checkpoint``, so
only the carries at chunk boundaries are kept for the backward pass and
each chunk recomputes its interior.  Recurrent cells with large carries
need it in training (an mLSTM's per-head matrix memory is O(head_dim^2)
a step).  The forward values are the plain loop's, bit for bit; with
autograd off (serving) it is the plain loop.

On the ``meta`` device (the dry run: shapes, no values) a scan runs its
first and last steps as they are and its second standing for the T - 2
between them: a step's shapes do not depend on t, and only the first
step's carry comes from outside and only the last one's goes out (their
backward passes differ).  A checkpointed scan does the same with its
chunks.
The trip count is kept where a cost counter reads it (``trip_scale``):
for the step's own ops while it runs and, with autograd on, for the
backward of every autograd node the step created, as the reference's
cost walk multiplies a ``lax.scan`` body by its length.
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


# trip counts of the meta scans running now: their steps' forward ops
# (_FWD_TRIPS) and the backward nodes they created (_BWD_TRIPS)
_FWD_TRIPS: list[int] = []
_BWD_TRIPS: list[int] = []


def trip_scale() -> int:
    """How many times the op running now stands for: the product of the
    trip counts of the meta scans around it (1 outside them).  A forward
    op inside a backward node (a checkpoint's recompute) counts by its own
    scans only."""
    return math.prod(_FWD_TRIPS or _BWD_TRIPS)


def counted_as_forward(fn: Callable) -> Callable:
    """``fn``, its ops counted by the meta scans around them only, also
    when it runs again inside a backward node (a checkpoint's
    recompute), where the node's own trip count must not apply."""
    def run(*args, **kwargs):
        _FWD_TRIPS.append(1)
        try:
            return fn(*args, **kwargs)
        finally:
            _FWD_TRIPS.pop()
    return run


def _seq_now() -> int:
    """The autograd sequence number of a node made now."""
    probe = torch.zeros((), device="meta", requires_grad=True)
    return (probe * 1).grad_fn._sequence_nr()


def _scale_backward(outs, since: int, n: int) -> None:
    """Hooks on every autograd node made after sequence number ``since``
    and reachable from ``outs``: each counts ``n`` times while it runs."""
    def push(*_):
        _BWD_TRIPS.append(n)

    def pop(*_):
        _BWD_TRIPS.pop()
    todo = [t.grad_fn for t in outs
            if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    seen = set()
    while todo:
        node = todo.pop()
        if node is None or node in seen or node._sequence_nr() <= since:
            continue
        seen.add(node)
        node.register_prehook(push)
        node.register_hook(pop)
        todo.extend(nxt for nxt, _ in node.next_functions)


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _join(y0, y, n: int, y_last, flatten: bool = False):
    """``y0``, ``n`` copies of ``y``, then ``y_last``, stacked along a new
    leading axis (``flatten``: joined along their own leading axis): new
    tensors, tied to all three for autograd."""
    if isinstance(y, (tuple, list)):
        return type(y)(_join(a, b, n, c, flatten)
                       for a, b, c in zip(y0, y, y_last))
    mid = y.unsqueeze(0).expand((n,) + tuple(y.shape))
    if flatten:
        return torch.cat([y0, mid.flatten(0, 1), y_last])
    return torch.cat([y0.unsqueeze(0), mid, y_last.unsqueeze(0)])


def _as_middle(run, carry, n: int):
    """``run(carry)`` standing for ``n`` steps: its forward ops scaled
    while it runs, its autograd nodes while they run."""
    since = _seq_now() if torch.is_grad_enabled() else None
    _FWD_TRIPS.append(n)
    try:
        carry, y = run(carry)
    finally:
        _FWD_TRIPS.pop()
    if since is not None:
        _scale_backward(_leaves(carry) + _leaves(y), since, n)
    return carry, y


def _meta_checkpointed(step: Callable, carry, xs, chunk: int, n: int):
    """A checkpointed scan on ``meta``: its first and last chunks as they
    are, its second standing for the n - 2 between them.  The middle
    chunk's own function scales its forward ops, so its recompute in the
    backward pass counts as often."""
    def middle(c):
        _FWD_TRIPS.append(n - 2)
        try:
            return scan(step, c, xs, chunk, 2 * chunk)
        finally:
            _FWD_TRIPS.pop()

    def region(lo):
        return lambda c: checkpoint(counted_as_forward(scan), step, c, xs,
                                    lo, lo + chunk, use_reentrant=False)
    carry, y0 = region(0)(carry)
    since = _seq_now()
    carry, y = checkpoint(middle, carry, use_reentrant=False)
    _scale_backward(_leaves(carry) + _leaves(y), since, n - 2)
    carry, y_last = region((n - 1) * chunk)(carry)
    return carry, _join(y0, y, n - 2, y_last, flatten=True)


def _meta_scan(step: Callable, carry, xs, lo: int, hi: int):
    """Steps lo, lo + 1 and hi - 1 of a scan on ``meta``, the second
    standing for the hi - lo - 2 between the others: the first step's
    carry comes in from outside and the last one's goes out, so their
    backward passes differ from the middle steps'."""
    carry, y0 = step(carry, _index(xs, lo))
    carry, y = _as_middle(lambda c: step(c, _index(xs, lo + 1)), carry,
                          hi - lo - 2)
    carry, y_last = step(carry, _index(xs, hi - 1))
    return carry, _join(y0, y, hi - lo - 2, y_last)


def fori_loop(body: Callable, n: int, carry):
    """``carry = body(t, carry)`` for t in range(n) (``jax.lax.
    fori_loop``).  On ``meta`` (``carry`` decides the device) the first
    and last iterations run and the second stands for the n - 2 between
    them (module docstring)."""
    if n > 3 and _leaves(carry)[0].device.type == "meta":
        carry = body(0, carry)
        carry, _ = _as_middle(lambda c: (body(1, c), ()), carry, n - 2)
        return body(n - 1, carry)
    for t in range(n):
        carry = body(t, carry)
    return carry


def scan(step: Callable, carry, xs, lo: int = 0, hi: int | None = None):
    """The plain loop ``carry, y_t = step(carry, xs[t])`` over t in [lo,
    hi).  ``xs``: a tensor or nested tuples of tensors with a leading time
    axis; returns (carry, the y_t stacked along a new leading axis).  On
    ``meta``: three steps for all (module docstring)."""
    hi = _first_leaf(xs).shape[0] if hi is None else hi
    if _first_leaf(xs).device.type == "meta" and hi - lo > 3:
        return _meta_scan(step, carry, xs, lo, hi)
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
    if _first_leaf(xs).device.type == "meta" and t // chunk > 3:
        return _meta_checkpointed(step, carry, xs, chunk, t // chunk)
    ys = []
    for lo in range(0, t, chunk):
        carry, y = checkpoint(scan, step, carry, xs, lo, lo + chunk,
                              use_reentrant=False)
        ys.append(y)
    return carry, _cat(ys)
