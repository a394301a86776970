"""Gradient compression: int8 quantization with error feedback (EF-SGD
style): counterpart of ``repro/optim/compress.py``.

In the reference the trainer quantizes gradients before the cross-pod
reduction and dequantizes after, with the error-feedback residual kept
beside the optimizer state; on one card the round trip is the same
function of the gradients (no reduction between).  Per tensor of the
reference's layer-stacked layout: the gradient plus the residual is
quantized to int8 with one float32 scale, and what the quantization lost
is the next residual.  On a rank mesh (``layout=``: the grads' tree of
``sharding.train.LeafShard``) the scale is the whole leaf's: the max of
its parts' maxima over every rank (exact in any order), so the codes
equal one process's where the gradients do; the residual is placed like
its gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.sharding import train as ST
from repro_torch.tree import (flatten, leaves, reference_groups,
                              tree_map, unflatten)


class EFState(NamedTuple):
    residual: dict  # the grads' tree, float32


def init_ef(grads_like) -> EFState:
    return EFState(tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        grads_like))


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 (round half to even).  Returns (q, scale
    0-dim float32)."""
    scale = (x.abs().max() + 1e-12) / 127.0
    return _codes(x, scale), scale


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads, ef: EFState, layout=None):
    """Quantize (grads + residual) to int8, keeping the new residual.
    Returns (a tree of (q, scale) tuples, new EFState).  The scale is the
    reference's per-tensor one in its stacked layout: the layers of a
    per-layer list share their leaf's scale (``tree.reference_groups``)."""
    flat = flatten(grads)
    corrected = [g.float() + r for (_, g), r in zip(flat,
                                                    leaves(ef.residual))]
    groups = reference_groups(grads)
    amax: dict = {}
    for key, c in zip(groups, corrected):
        m = c.abs().max()
        amax[key] = m if key not in amax else torch.maximum(amax[key], m)
    if layout is not None:
        keys = list(amax)
        amax = dict(zip(keys, ST.world_max(torch.stack(
            [amax[k] for k in keys])).unbind()))
    qs, res = [], []
    for key, c in zip(groups, corrected):
        scale = (amax[key] + 1e-12) / 127.0
        q = _codes(c, scale)
        qs.append((q, scale))
        res.append(c - dequantize_int8(q, scale))
    return unflatten(grads, qs), EFState(unflatten(grads, res))


def decompress_grads(qgrads):
    return tree_map(lambda qs: dequantize_int8(*qs), qgrads)


def compression_error(grads, ef_before: EFState, ef_after: EFState):
    """Diagnostic: the relative L2 error this step introduced."""
    num = sum(r.square().sum() for r in leaves(ef_after.residual))
    den = sum(g.float().square().sum() for g in leaves(grads)) + 1e-12
    return torch.sqrt(num / den)
