"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule: counterpart of ``repro/optim/adamw.py``.

Plain functions over the param tree, not ``torch.optim.AdamW`` (which
folds the decay in as ``p * (1 - lr * wd)`` and decays every leaf).  The
arithmetic is the reference's, op for op: clip scale, ``m``, ``v``, bias
corrections, ``delta``, the decay term, then ``p - lr * delta`` cast back
to the leaf's dtype.  The schedule's scalars are float32, as the
reference's.  The moments and the params are updated in place (the
caller's tensors), so a step holds no second copy of the optimizer state.

Decay: the reference decays a leaf when its rank is at least 2, in its
layout, which stacks every layer's leaves along a leading axis; so a
block's norm scale (L, d) is decayed while ``final_norm`` (d,) is not.  The
port keeps one dict a layer, so a leaf inside one of the per-layer lists
(``tree.LAYER_LISTS``) counts its rank plus one.

On a rank mesh each rank holds its part of every leaf (``sharding/
train.py``): ``layout=`` (the params' tree of ``LeafShard``) makes the
gradient norm the whole tree's, each distinct part's sum of squares
counted once and summed over the ranks in rank order, the same on every
rank; the clip scale and the update are then local to each part.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.sharding import train as ST
from repro_torch.tree import flatten, reference_ndim, tree_map

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: int
    mu: dict
    nu: dict


def cosine_lr(cfg: AdamWConfig, step: int) -> np.float32:
    """Linear warmup to ``lr_peak``, then a cosine down to ``lr_min`` at
    ``decay_steps``; float32 arithmetic as the reference's."""
    f32 = np.float32
    s = f32(step)
    warm = f32(cfg.lr_peak) * s / f32(max(cfg.warmup_steps, 1))
    t = np.clip((s - f32(cfg.warmup_steps))
                / f32(max(cfg.decay_steps - cfg.warmup_steps, 1)),
                f32(0.0), f32(1.0))
    cos = f32(cfg.lr_min) + f32(0.5) * f32(cfg.lr_peak - cfg.lr_min) * (
        f32(1.0) + np.cos(f32(math.pi) * t))
    return f32(warm if s < f32(cfg.warmup_steps) else cos)


def init_adamw(params) -> AdamWState:
    """Float32 zero moments for every leaf, on the leaf's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree, layout=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares;
    with ``layout`` (on a mesh), of each whole leaf's (``sharding.train.
    tree_sum``)."""
    sq = [x.float().square().sum() for _, x in flatten(tree)]
    if layout is not None:
        return ST.tree_sum(sq, layout).sum().sqrt()
    return torch.stack(sq).sum().sqrt()


def adamw_update(cfg: AdamWConfig, params, grads, state: AdamWState,
                 layout=None):
    """One step.  Returns (params, state, metrics ``{"grad_norm", "lr"}``);
    ``params`` and the moments are the caller's tensors, updated in
    place.  ``grads`` are not kept.  ``layout``: the params' placement on
    a mesh (the norm is the whole tree's)."""
    gnorm = global_norm(grads, layout)
    # clip / norm as a true division (a Python scalar over a tensor would
    # multiply by the norm's reciprocal)
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    f32 = np.float32
    lr = cosine_lr(cfg, step)
    b1c = f32(1.0) - f32(cfg.b1) ** f32(step)
    b2c = f32(1.0) - f32(cfg.b2) ** f32(step)
    flat_p = flatten(params)
    flat_g = [g for _, g in flatten(grads)]
    flat_m = [m for _, m in flatten(state.mu)]
    flat_v = [v for _, v in flatten(state.nu)]
    consts: dict = {}

    def scalars(dev):
        """The step's float32 scalars on ``dev``, copied over once."""
        if dev not in consts:
            vals = torch.tensor(
                [cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2, b1c, b2c, cfg.eps,
                 cfg.weight_decay, lr], dtype=torch.float32)
            consts[dev] = vals.to(dev).unbind()
        return consts[dev]
    with torch.no_grad():
        for (path, p), g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            b1, b1m, b2, b2m, c1, c2, eps, wd, lr_t = scalars(p.device)
            g = g.float() * scale
            m.mul_(b1).add_(g * b1m)
            v.mul_(b2).add_(g.square_().mul_(b2m))
            del g
            den = (v / c2).sqrt_().add_(eps)
            delta = (m / c1).div_(den)
            del den
            if reference_ndim(path, p) >= 2:
                delta.add_(wd * p.float())
            p.copy_(p.float() - lr_t * delta)
    return params, AdamWState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr}
