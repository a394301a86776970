"""Attention for the dense decode path: counterpart of
``repro/layers/attention.py`` (causal self-attention with GQA; prefill
attention; KV-cache decode, int8 KV included; decode against the paged KV
pool).  The reference's other
flavours (QKV bias, qk-norm, logit softcap, sliding window, cross
attention) are not ported; ``models/lm.py`` rejects configs that set them.

Layouts are the reference's: q (B, S, H, hd), caches (B, S, K, hd).  Unlike
the functional reference, the KV cache is updated in place (no copy of the
cache per step); ``update_kv_cache`` and ``decode_attend`` return the same
dict they were given.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops, ref
from repro_torch.layers.rope import apply_rope

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    # paged decode through the paged-attention kernels (float pools only)
    paged_kernel: bool = False


def init_attention(generator: torch.Generator, cfg: AttentionConfig,
                   dtype=torch.float32, device="cpu") -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def draw(shape, scale):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)
    return {
        "wq": draw((d, h * hd), d ** -0.5),
        "wk": draw((d, kvh * hd), d ** -0.5),
        "wv": draw((d, kvh * hd), d ** -0.5),
        "wo": draw((h * hd, d), (h * hd) ** -0.5),
    }


def _project_qkv(params: dict, x: torch.Tensor, cfg: AttentionConfig):
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"].to(x.dtype)).reshape(b, -1, h, hd)
    k = (x @ params["wk"].to(x.dtype)).reshape(b, -1, kvh, hd)
    v = (x @ params["wv"].to(x.dtype)).reshape(b, -1, kvh, hd)
    return q, k, v


def flash_attention(q, k, v, q_positions: torch.Tensor,
                    k_positions: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention in float32 over the whole sequence (the
    reference chunks it with a running max/sum; the result is the same up
    to float rounding).  q: (B, Sq, H, hd); k, v: (B, Sk, K, hd)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, sq, kvh, rep, hd).float()
    s = torch.einsum("bqkrh,btkh->bkrqt", qg, k.float()) * (hd ** -0.5)
    mask = q_positions[:, None] >= k_positions[None, :]
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrqt,btkh->bqkrh", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def attend(params: dict, x: torch.Tensor, cfg: AttentionConfig,
           positions: torch.Tensor, return_kv: bool = False):
    """Prefill self-attention.  x: (B, S, d).  ``return_kv`` also returns
    the roped K/V for seeding the decode cache."""
    q, k, v = _project_qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, k, v, positions, positions)
    b, s = x.shape[0], x.shape[1]
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ \
        params["wo"].to(x.dtype)
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------- decode ---

def init_kv_cache(batch: int, max_len: int, cfg: AttentionConfig,
                  dtype=torch.bfloat16, device="cpu") -> dict:
    """KV cache; int8 storage carries per-(B, S, K) bfloat16 scales that
    factor out of the attention products."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        cache["k_scale"] = torch.zeros(shape[:3], dtype=torch.bfloat16,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape[:3], dtype=torch.bfloat16,
                                       device=device)
    return cache


def _quantize_kv(x: torch.Tensor):
    """(B, S, K, hd) -> int8 values (round half to even) + per-(B, S, K)
    bfloat16 scale."""
    xf = x.float()
    scale = xf.abs().amax(-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def update_kv_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                    index) -> dict:
    """Write (B, S_new, K, hd) at sequence offset ``index`` in place:
    a scalar (one offset for every slot) or (B,) per-slot offsets."""
    idx = torch.as_tensor(index, device=cache["k"].device).long()
    if cache["k"].dtype == torch.int8:
        (kq, ks), (vq, vs) = _quantize_kv(k_new), _quantize_kv(v_new)
        upd = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        upd = {"k": k_new, "v": v_new}
    s_new = k_new.shape[1]
    for name, val in upd.items():
        buf = cache[name]
        val = val.to(buf.dtype)
        if idx.ndim == 0:
            i = int(idx)
            buf[:, i:i + s_new] = val
        else:
            pos = idx[:, None] + torch.arange(s_new, device=buf.device)
            rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
            buf[rows, pos] = val
    return cache


def chunk_attend(params: dict, x: torch.Tensor, cfg: AttentionConfig,
                 cache: dict, offset: int, valid=None):
    """Chunked-prefill attention: an S-token chunk at sequence ``offset``
    attends the KV cache (every earlier chunk plus itself).  x: (B, S, d);
    ``valid`` (scalar or (B,)) is the prompt's real length: K/V of chunk rows
    at positions >= valid are zeroed before the cache write, so the cache
    holds what a monolithic prefill leaves there.  Chunks arrive in order
    from offset 0; the causal mask keeps positions past the chunk out.
    Returns (out (B, S, d), cache updated in place)."""
    b, s = x.shape[0], x.shape[1]
    q_pos = offset + torch.arange(s, device=x.device)              # (S,)
    q, k, v = _project_qkv(params, x, cfg)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, q_pos, cfg.rope_theta)
    if valid is not None:
        vld = torch.as_tensor(valid, device=x.device)
        live = q_pos < (vld[:, None] if vld.ndim else vld)
        live = live.reshape(-1, s)[:, :, None, None]               # (B|1,S,..)
        k = torch.where(live, k, torch.zeros_like(k))
        v = torch.where(live, v, torch.zeros_like(v))
    cache = update_kv_cache(cache, k, v, offset)
    ck, cv = cache["k"], cache["v"]
    if ck.dtype == torch.int8:
        ck = (ck.float() * cache["k_scale"].float()[..., None]).to(x.dtype)
        cv = (cv.float() * cache["v_scale"].float()[..., None]).to(x.dtype)
    else:
        ck, cv = ck.to(x.dtype), cv.to(x.dtype)
    k_pos = torch.arange(ck.shape[1], device=x.device)
    out = flash_attention(q, ck, cv, q_pos, k_pos)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return out @ params["wo"].to(x.dtype), cache


def _as_compute(t: torch.Tensor) -> torch.Tensor:
    """Cache operand of a decode product as float32: int8 values are read
    as bfloat16, as the reference multiplies them (exact either way)."""
    if t.dtype == torch.int8:
        return t.to(torch.bfloat16).float()
    return t.float()


def decode_scores(q, cache_k, cfg: AttentionConfig):
    """q (B, 1, H, hd) vs cache (B, S, K, hd) -> float32 scores
    (B, K, rep, S), unmasked.

    The reference multiplies in the cache's dtype (bfloat16 for an int8
    cache) with float32 accumulation; here both operands are rounded to that
    dtype and multiplied in float32, where their products are exact, so the
    two differ only in summation order."""
    b, _, h, hd = q.shape
    kvh = cfg.n_kv_heads
    op_dtype = torch.bfloat16 if cache_k.dtype == torch.int8 \
        else cache_k.dtype
    qg = q.reshape(b, kvh, h // kvh, hd).to(op_dtype).float()
    return torch.einsum("bkrh,btkh->bkrt", qg,
                        _as_compute(cache_k)) * (hd ** -0.5)


def decode_attend_partial(q, cache_k, cache_v, cfg: AttentionConfig,
                          kv_positions: torch.Tensor, q_position,
                          k_scale=None, v_scale=None):
    """Unnormalized decode attention over the cache: (o, l, m).
    ``kv_positions`` (S,) or (B, S); ``q_position`` scalar or (B,).
    int8 caches pass their scales, applied to the scores and folded into p.
    """
    s = decode_scores(q, cache_k, cfg)                        # (B,K,rep,S)
    if k_scale is not None:
        s = s * k_scale.float().transpose(1, 2)[:, :, None, :]
    q_pos = torch.as_tensor(q_position, device=s.device)
    if q_pos.ndim:
        q_pos = q_pos[:, None]
    mask = kv_positions <= q_pos
    if mask.ndim == 2:                                        # (B, S)
        mask = mask[:, None, None, :]
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=s.device))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    if v_scale is not None:
        pv = p * v_scale.float().transpose(1, 2)[:, :, None, :]
        o = torch.einsum("bkrt,btkh->bkrh", pv.to(torch.bfloat16).float(),
                         _as_compute(cache_v))
    else:
        o = torch.einsum("bkrt,btkh->bkrh", p.to(cache_v.dtype).float(),
                         cache_v.float())
    return o, l, m


def finalize_decode(o, l, params: dict, x_dtype, cfg: AttentionConfig):
    out = o / torch.clamp(l, min=1e-30)[..., None]
    b = out.shape[0]
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim).to(x_dtype)
    return out @ params["wo"].to(x_dtype)


def q_pos_sentinel(s_max: int, cache_len: torch.Tensor) -> torch.Tensor:
    return s_max + cache_len + 1


def decode_attend(params: dict, x: torch.Tensor, cfg: AttentionConfig,
                  cache: dict, cache_len,
                  kv_positions: Optional[torch.Tensor] = None) -> tuple:
    """Single-token decode.  x: (B, 1, d); ``cache_len`` scalar or (B,)
    per-slot lengths.  Returns (out (B, 1, d), cache updated in place)."""
    cl = torch.as_tensor(cache_len, device=x.device).long()
    per_slot = cl.ndim == 1
    pos = cl[:, None] if per_slot else cl.reshape(1)[None]
    q, k, v = _project_qkv(params, x, cfg)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    cache = update_kv_cache(cache, k, v, cl)
    s_max = cache["k"].shape[1]
    if kv_positions is None:
        kv_positions = torch.arange(s_max, device=x.device)
    cmp = cl[:, None] if per_slot else cl
    live = kv_positions <= cmp
    sent = q_pos_sentinel(s_max, cl)
    kvp = torch.where(live, kv_positions, sent[:, None] if per_slot else sent)
    o, l, _ = decode_attend_partial(q, cache["k"], cache["v"], cfg, kvp, cl,
                                    cache.get("k_scale"),
                                    cache.get("v_scale"))
    return finalize_decode(o, l, params, x.dtype, cfg), cache


# -------------------------------------------------------------- paged KV ---
# The paged KV pool keeps each layer's cache as a global block pool, leaves
# (N, block, K, hd) instead of per-slot (B, max_len, K, hd); a per-slot
# block table (B, max_len/block) maps each slot's logical sequence blocks
# onto pool blocks.  The decode step writes the new token's K/V into its
# slot's pool block and attends the slot's pages.  The gather route gathers
# the table back into the dense per-slot view and runs the decode math of
# ``decode_attend`` on the same shapes, so it is bitwise the dense path;
# stale content in recycled blocks sits on masked lanes only, where its
# softmax weight is exactly +0.0.  Like the dense cache, the pool is
# updated in place.

def _write_target(table: torch.Tensor, cache_len: torch.Tensor, bs: int):
    """Pool block and row of each slot's write position ``cache_len``."""
    blk = table.gather(1, (cache_len // bs)[:, None].to(torch.long))[:, 0]
    return blk, (cache_len % bs).to(torch.int32)


def paged_update_kv(pool: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                    table: torch.Tensor, cache_len: torch.Tensor) -> dict:
    """Write one token per slot into the pool, in place: (B, 1, K, hd) K/V
    at per-slot position ``cache_len`` lands in block
    ``table[b, pos // block]`` at row ``pos % block``.  Slots parked on the
    shared write-off block collide there; the last slot wins."""
    blk, off = _write_target(table, cache_len, pool["k"].shape[1])
    if pool["k"].dtype == torch.int8:
        (kq, ks), (vq, vs) = _quantize_kv(k_new), _quantize_kv(v_new)
        upd = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        upd = {"k": k_new, "v": v_new}
    for name, val in upd.items():
        ref.paged_kv_write_ref(pool[name], val[:, 0], blk, off)
    return pool


def paged_gather_kv(pool: dict, table: torch.Tensor) -> dict:
    """Per-slot dense views of the pool: leaves (N, block, ...) and table
    (B, nbps) -> (B, nbps * block, ...), the shapes the dense decode
    attends."""
    b, nbps = table.shape
    tab = table.long()
    return {k: v[tab].reshape((b, nbps * v.shape[1]) + v.shape[2:])
            for k, v in pool.items()}


def paged_decode_attend(params: dict, x: torch.Tensor, cfg: AttentionConfig,
                        pool: dict, cache_len, table: torch.Tensor) -> tuple:
    """Single-token decode against a paged KV pool.  x (B, 1, d); ``pool``
    holds this layer's block-pool leaves; ``table`` (B, nbps) int32;
    ``cache_len`` (B,) per-slot lengths.  Returns (out (B, 1, d), pool
    updated in place).

    With ``cfg.paged_kernel`` and a float pool the K/V write and the
    attention run on the paged kernels (``ops.paged_kv_write`` twice, then
    ``ops.paged_attention``); an int8 pool always takes the gather route,
    as in the reference, where its scale epilogue lives."""
    cl = torch.as_tensor(cache_len, device=x.device)
    if cl.ndim != 1:
        raise ValueError("paged decode runs per slot: cache_len must be "
                         "(B,)")
    cl = cl.long()
    pos = cl[:, None]
    q, k, v = _project_qkv(params, x, cfg)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if cfg.paged_kernel and pool["k"].dtype != torch.int8:
        blk, off = _write_target(table, cl, pool["k"].shape[1])
        ops.paged_kv_write(pool["k"], k[:, 0], blk, off)
        ops.paged_kv_write(pool["v"], v[:, 0], blk, off)
        ctx = ops.paged_attention(q[:, 0], pool["k"], pool["v"], table, cl)
        b = x.shape[0]
        out = ctx.reshape(b, 1, cfg.n_heads * cfg.head_dim).to(x.dtype)
        return out @ params["wo"].to(x.dtype), pool
    pool = paged_update_kv(pool, k, v, table, cl)
    dense = paged_gather_kv(pool, table)
    s_max = dense["k"].shape[1]
    kv_positions = torch.arange(s_max, device=x.device)
    live = kv_positions <= cl[:, None]
    kvp = torch.where(live, kv_positions,
                      q_pos_sentinel(s_max, cl)[:, None])
    o, l, _ = decode_attend_partial(q, dense["k"], dense["v"], cfg, kvp, cl,
                                    dense.get("k_scale"),
                                    dense.get("v_scale"))
    return finalize_decode(o, l, params, x.dtype, cfg), pool
