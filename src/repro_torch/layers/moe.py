"""Mixture-of-Experts layer: the counterpart of ``repro/layers/moe.py``.

A float32 router picks each token's top-k experts; a sort-based dispatch
ranks the slots within each expert by router weight and keeps at most a
capacity of them per expert and dispatch group (overflow drops the
least-confident slots first); each kept slot runs its expert's gated FFN
and is added back to its token, weighted.  Always-on shared experts
(deepseek-moe) are a dense gated MLP on top.

Dispatch groups: a (B, S, d) input routes each sequence as its own group
(decode feeds (B, 1, d): a group of one token, which never overflows); a
flat (T, d) input is one group.

The reference computes every expert over a zero-filled (G, E, C, d) buffer.
An expert with no kept slot adds exactly 0, so this port computes only the
experts that hold a kept slot, on their rows gathered from the stacks
before any cast to the compute dtype: the same function, up to summation
order.  Each token's weighted expert outputs are summed in a fixed order
(its k slots), so a run on the card is repeatable.  The expert products are
``torch.bmm``: in the reference they are einsums outside any Pallas
kernel, so there is no kernel to port here.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import sparse_mlp as SM
from repro_torch.core.relufication import get_activation


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_expert: int                 # per-expert FFN width
    n_experts: int
    top_k: int
    n_shared: int = 0             # deepseek shared experts (always-on)
    d_shared: int = 0             # width of the shared expert FFN
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # renormalize top-k probs (deepseek)
    aux_loss_coef: float = 0.01
    activation: str = "silu"


def init_moe(generator: torch.Generator, cfg: MoEConfig,
             dtype=torch.float32, device="cpu") -> dict:
    """Router (d, E) float32 and neuron-major expert stacks (E, f, d), so
    a gated expert's rows are laid out as a sparse MLP's; ``shared`` a
    gated MLP of width ``d_shared`` (or ``d_expert * n_shared``)."""
    d, f, e = cfg.d_model, cfg.d_expert, cfg.n_experts

    def draw(shape, scale, dt):
        return torch.randn(shape, generator=generator,
                           device=device).mul_(scale).to(dt)
    params = {
        "router": draw((d, e), d ** -0.5, torch.float32),
        "wg_t": draw((e, f, d), d ** -0.5, dtype),
        "wu_t": draw((e, f, d), d ** -0.5, dtype),
        "wd_t": draw((e, f, d), f ** -0.5, dtype),
    }
    if cfg.n_shared > 0:
        width = cfg.d_shared or cfg.d_expert * cfg.n_shared
        params["shared"] = SM.init_gated_mlp(generator, d, width, dtype=dtype,
                                             device=device)
    return params


def router_probs(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """x: (..., d) -> (probs (..., E) float32, logits); the router
    weights in float32 whatever their dtype, as jnp promotes them."""
    logits = x.float() @ params["router"].float()
    return torch.softmax(logits, dim=-1), logits


def _topk_route(probs: torch.Tensor, cfg: MoEConfig):
    """The top-k experts of each token, largest probability first, ties
    to the lower expert index (``lax.top_k``'s order: a stable sort)."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :cfg.top_k], idx[..., :cfg.top_k]
    if cfg.router_norm_topk:
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx


def aux_load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                          cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss."""
    e = cfg.n_experts
    flat = idx.reshape(-1).long()
    # the expert counts of bincount(minlength=e), with a shape that does
    # not depend on the ids (the dry run's meta tensors have none)
    hits = flat.new_zeros(e).scatter_add_(0, flat,
                                          torch.ones_like(flat)).float()
    frac_tokens = hits / torch.clamp(hits.sum(), min=1.0)
    frac_probs = probs.mean(0)
    return cfg.aux_loss_coef * e * torch.sum(frac_tokens * frac_probs)


def _capacity(cfg: MoEConfig, n_tokens: int, n_local_experts: int) -> int:
    per_expert = n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts
    return max(8, int(-(-per_expert // 8) * 8))


# the rank key's weight factor, as the reference rounds it: float32
_KEY_W = 1.0 - 1e-6


class Slots(NamedTuple):
    """A dispatch: each group's G x (Tg * K) slots sorted by (expert,
    descending weight), stable.  ``order`` maps a sorted position to its
    slot (token t's k-th choice is slot t * K + k); ``keep`` is False where
    the slot overflowed its expert's capacity ``cap``."""
    order: torch.Tensor      # (G, nslot) int64
    expert: torch.Tensor     # (G, nslot) sorted expert ids
    token: torch.Tensor      # (G, nslot) token within the group
    weight: torch.Tensor     # (G, nslot) float32 router weight
    keep: torch.Tensor       # (G, nslot) bool
    cap: int


def dispatch_slots(w: torch.Tensor, idx: torch.Tensor,
                   cfg: MoEConfig) -> Slots:
    """The reference's sort-based capacity dispatch of routing ``w, idx``
    (G, Tg, K): slots ranked within an expert by the float32 key
    ``e * 2 - w * (1 - 1e-6)`` under a stable sort, the first ``cap`` of
    each expert kept."""
    g, tg, k = idx.shape
    e = cfg.n_experts
    cap = _capacity(cfg, tg, e)
    nslot = tg * k
    flat_e = idx.reshape(g, nslot)
    flat_w = w.reshape(g, nslot)
    key = flat_e.float() * 2.0 - flat_w * torch.tensor(
        _KEY_W, dtype=torch.float32, device=w.device)
    order = torch.argsort(key, dim=-1, stable=True)
    e_s = torch.gather(flat_e, 1, order)
    t_s = torch.div(order, k, rounding_mode="floor")
    w_s = torch.gather(flat_w, 1, order)
    bounds = torch.arange(e + 1, device=idx.device).expand(g, e + 1)
    seg_start = torch.searchsorted(e_s.contiguous(), bounds.contiguous())
    pos = torch.arange(nslot, device=idx.device)[None] - torch.gather(
        seg_start, 1, e_s)
    return Slots(order, e_s, t_s, w_s, pos < cap, cap)


def _expert_ffn(params: dict, x: torch.Tensor, expert: torch.Tensor,
                activation: str) -> torch.Tensor:
    """Row i of ``x`` (n, d) through expert ``expert[i]``'s gated FFN ->
    (n, d) in x's dtype.  Only the experts named run: their slots packed
    into an (n_occupied, C_max, d) buffer, their weight rows gathered
    from the stacks and then cast.  On ``meta`` (the dry run: shapes, no
    values) the rows spread evenly over min(E, n) experts, the slots' own
    work without padding."""
    n, d = x.shape
    if x.device.type == "meta":
        n_occ = min(params["wg_t"].shape[0], n)
        occ = torch.arange(n_occ, device=x.device)
        inv = expert
        pos = torch.arange(n, device=x.device) % -(-n // n_occ)
        buf = x.new_zeros((n_occ, -(-n // n_occ), d))
    else:
        occ, inv, counts = torch.unique(expert, return_inverse=True,
                                        return_counts=True)
        rank = torch.argsort(inv, stable=True)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.empty_like(inv)
        pos[rank] = torch.arange(n, device=x.device) - starts[inv[rank]]
        buf = x.new_zeros((occ.numel(), int(counts.max()), d))
    buf[inv, pos] = x

    def take(name):
        return params[name].index_select(0, occ).to(x.dtype)
    act = get_activation(activation)
    h = act(torch.bmm(buf, take("wg_t").transpose(1, 2))) * torch.bmm(
        buf, take("wu_t").transpose(1, 2))
    return torch.bmm(h, take("wd_t"))[inv, pos]


def _dispatch_compute(params: dict, x: torch.Tensor, cfg: MoEConfig,
                      w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (G, Tg, d), routing (G, Tg, K) -> (G, Tg, d): each kept slot's
    expert output times its weight (cast to x's dtype), summed per token
    over its k slots.  On ``meta`` every slot counts as kept."""
    g, tg, d = x.shape
    k = cfg.top_k
    sl = dispatch_slots(w, idx, cfg)
    goff = torch.arange(g, device=x.device)[:, None] * (tg * k)
    if x.device.type == "meta":
        kept = torch.arange(g * tg * k, device=x.device)
    else:
        kept = sl.keep.reshape(-1).nonzero().squeeze(1)
    slot = (sl.order + goff).reshape(-1)[kept]        # global slot id
    out = x.new_zeros((g * tg * k, d))
    if kept.numel():
        xs = x.reshape(g * tg, d)[torch.div(slot, k, rounding_mode="floor")]
        ys = _expert_ffn(params, xs, sl.expert.reshape(-1)[kept],
                         cfg.activation)
        out[slot] = ys * sl.weight.reshape(-1)[kept][:, None].to(x.dtype)
    return out.reshape(g, tg, k, d).sum(2)


def _groups(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    return x.reshape(x.shape[0], -1, d) if x.ndim == 3 else \
        x.reshape(1, -1, d)


def route(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """The routing of ``moe_apply``'s input x: (probs (G, Tg, E), weights
    and expert ids (G, Tg, K)) over its dispatch groups."""
    probs, _ = router_probs(params, _groups(x), cfg)
    return (probs, *_topk_route(probs, cfg))


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """MoE layer.  x: (..., d) -> (y (..., d) in x's dtype, aux
    load-balance loss).  For (B, S, d) inputs each sequence is a dispatch
    group; flat (T, d) inputs form one group."""
    probs, w, idx = route(params, x, cfg)
    y = _dispatch_compute(params, _groups(x), cfg, w, idx).reshape(x.shape)
    aux = aux_load_balance_loss(probs.reshape(-1, cfg.n_experts),
                                idx.reshape(-1, cfg.top_k), cfg)
    if "shared" in params:
        # always-on shared experts: a dense gated MLP (deepseek-moe)
        y = y + SM.dense_mlp(params["shared"], x,
                             SM.SparseInferConfig(activation=cfg.activation))
    return y, aux
