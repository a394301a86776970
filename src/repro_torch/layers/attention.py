"""Attention: counterpart of ``repro/layers/attention.py``: causal
self-attention with GQA/MQA, QKV bias, per-head qk RMSNorm, a logit
softcap and a sliding window; an encoder's non-causal self-attention;
cross attention against encoder states or image embeddings (no RoPE, no
mask, no window), at prefill and at decode against K/V computed once per
request (``cross_decode_attend``, ``precompute_cross_kv``); prefill and
chunked-prefill attention, blocked over K/V by ``attn_chunk`` with a
running max and sum (``flash_attention``); KV-cache decode, int8 KV
included; decode against the paged KV pool.

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
from repro_torch.layers.norms import init_rmsnorm, rmsnorm
from repro_torch.layers.rope import apply_rope
from repro_torch.layers.scan_utils import fori_loop
from repro_torch.sharding import rules as R

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False          # qwen1.5
    qk_norm: bool = False           # qwen3
    softcap: float = 0.0            # gemma2 attention logit softcap
    rope_theta: float = 10000.0
    window: int = 0                 # sliding window; 0 = full attention
    causal: bool = True
    cross: bool = False             # K/V from encoder states or images
    d_kv_input: int = 0             # width of those states (0: d_model)
    # paged decode through the paged-attention kernels (float pools only)
    paged_kernel: bool = False
    # the heads above are this rank's share of heads split over this many
    # ranks of the current mesh's 'model' line (``models/common.py:
    # attn_cfg``): the out projection is a partial sum, combined over it
    head_shards: int = 1


def init_attention(generator: torch.Generator, cfg: AttentionConfig,
                   dtype=torch.float32, device="cpu") -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d_kv = cfg.d_kv_input or d

    def draw(shape, scale):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)
    params = {
        "wq": draw((d, h * hd), d ** -0.5),
        "wk": draw((d_kv, kvh * hd), d_kv ** -0.5),
        "wv": draw((d_kv, kvh * hd), d_kv ** -0.5),
        "wo": draw((h * hd, d), (h * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kvh * hd),
                            ("bv", kvh * hd)):
            params[name] = torch.zeros((width,), dtype=dtype, device=device)
    if cfg.qk_norm:
        params["q_norm"] = init_rmsnorm(hd, dtype, device)
        params["k_norm"] = init_rmsnorm(hd, dtype, device)
    return params


def _promoted_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted dtype of the two, as jnp's matmul takes
    mixed operands (float32 image embeddings against bfloat16 weights)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _out_proj(ctx: torch.Tensor, params: dict, cfg: AttentionConfig,
              x_dtype) -> torch.Tensor:
    """(..., H * hd) attention context -> (..., d) through ``wo`` in
    ``x_dtype``.  With heads split over the mesh (``cfg.head_shards``) a
    rank's ``wo`` holds its heads' rows: its partial is taken in float32
    on the operands rounded to ``x_dtype`` (as the whole product rounds
    them), the line's partials are summed in rank order
    (``rules.model_sum``) and rounded to ``x_dtype`` once, the same bits
    on every rank."""
    if cfg.head_shards == 1:
        return ctx.to(x_dtype) @ params["wo"].to(x_dtype)
    part = ctx.to(x_dtype).float() @ params["wo"].to(x_dtype).float()
    return R.model_sum(part).to(x_dtype)


def _project_qkv(params: dict, x: torch.Tensor, cfg: AttentionConfig,
                 kv_x: Optional[torch.Tensor] = None):
    """Q, K and V in the reference's order: projection, bias, heads, then
    the per-head RMSNorm (RoPE follows at the caller).  The attention width
    ``n_heads * head_dim`` need not be ``d_model`` (gemma2: 2048 vs 2304).
    ``kv_x``: K and V project these states instead of ``x`` (cross
    attention), with the weights in ``x``'s dtype."""
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.head_shards > 1:
        # the replicated x enters this rank's heads: its gradient is the
        # line's
        x = R.model_entry(x)
    src = x if kv_x is None else kv_x
    q = x @ params["wq"].to(x.dtype)
    k = _promoted_matmul(src, params["wk"].to(x.dtype))
    v = _promoted_matmul(src, params["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(b, -1, h, hd)
    k = k.reshape(b, -1, kvh, hd)
    v = v.reshape(b, -1, kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    return q, k, v


def _softcap(s: torch.Tensor, cfg: AttentionConfig) -> torch.Tensor:
    """The logit softcap on scaled scores, in the reference's order:
    ``tanh(s / softcap) * softcap``."""
    if cfg.softcap > 0.0:
        return torch.tanh(s / cfg.softcap) * cfg.softcap
    return s


def _chunk_mask(cfg: AttentionConfig, q_pos: torch.Tensor,
                k_pos: torch.Tensor) -> Optional[torch.Tensor]:
    """(Sq, Ck) liveness of one K/V block, the reference's
    ``_chunk_scores`` mask: a key is live when ``k_pos <= q_pos`` (causal
    self-attention) and ``q_pos - k_pos < window``; cross attention masks
    nothing (None)."""
    mask = None
    if cfg.causal and not cfg.cross:
        mask = q_pos[:, None] >= k_pos[None, :]
    if cfg.window > 0 and not cfg.cross:
        near = (q_pos[:, None] - k_pos[None, :]) < cfg.window
        mask = near if mask is None else mask & near
    return mask


def flash_attention(q, k, v, cfg: AttentionConfig, q_positions: torch.Tensor,
                    k_positions: torch.Tensor,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Softmax attention in float32 over K/V blocks of ``kv_chunk`` keys
    with a running max ``m``, sum ``l`` and accumulator, in the reference's
    order (``repro/layers/attention.py:flash_attention``), with its masks,
    softcap and window (``_chunk_mask``).  q: (B, Sq, H, hd); k, v: (B, Sk,
    K, hd) -> (B, Sq, H, hd) in q's dtype.

    Two deliberate differences, neither of which changes the function: the
    reference's query blocks are independent, so every query row runs in
    one batch (no query chunk); and where ``kv_chunk`` does not divide Sk
    the last block is shorter, where the reference shrinks the chunk to
    the largest divisor of Sk (1 at a prime length).  No tensor allocated
    here grows with Sq x Sk: the scores of one block are (B, H, Sq,
    kv_chunk), one K/V block (B, kv_chunk, K, hd) and the output (B, Sq,
    H, hd).  On ``meta`` (the dry run) one full block stands for all of
    them (``scan_utils.fori_loop``)."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    step = max(1, min(kv_chunk, sk))
    qg = q.reshape(b, sq, kvh, rep, hd).float()
    neg = torch.tensor(NEG_INF, device=q.device)

    def block(lo: int, width: int, carry):
        m, l, acc = carry
        s = torch.einsum("bqkrh,btkh->bkrqt", qg,
                         k[:, lo:lo + width].float()) * (hd ** -0.5)
        s = _softcap(s, cfg)
        mask = _chunk_mask(cfg, q_positions, k_positions[lo:lo + width])
        if mask is not None:
            s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkrqt,btkh->bkrqh", p, v[:, lo:lo + width].float())
        return m_new, l, acc

    carry = (torch.full((b, kvh, rep, sq), NEG_INF, device=q.device),
             torch.zeros((b, kvh, rep, sq), device=q.device),
             torch.zeros((b, kvh, rep, sq, hd), device=q.device))
    n_full = sk // step
    carry = fori_loop(lambda j, c: block(j * step, step, c), n_full, carry)
    if sk % step:
        carry = block(n_full * step, sk % step, carry)
    _, l, acc = carry
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def attend(params: dict, x: torch.Tensor, cfg: AttentionConfig,
           positions: torch.Tensor, return_kv: bool = False,
           kv_x: Optional[torch.Tensor] = None,
           kv_positions: Optional[torch.Tensor] = None,
           kv_chunk: int = 1024):
    """Prefill attention, self or (``cfg.cross``, K/V from ``kv_x`` (B, T,
    d_kv) at ``kv_positions``) cross.  x: (B, S, d).  ``return_kv`` also
    returns the K/V (roped for self-attention) for seeding the decode
    cache.  ``kv_chunk``: the K/V block of ``flash_attention`` (the
    models pass ``cfg.attn_chunk``)."""
    q, k, v = _project_qkv(params, x, cfg, kv_x)
    if kv_positions is None:
        kv_positions = positions
    if not cfg.cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    out = flash_attention(q, k, v, cfg, positions, kv_positions,
                          kv_chunk)
    b, s = x.shape[0], x.shape[1]
    out = _out_proj(out.reshape(b, s, cfg.n_heads * cfg.head_dim), params,
                    cfg, x.dtype)
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
    a scalar (one offset for every slot; a Python int is used as it is,
    so a ``meta`` cache needs no value read) or (B,) per-slot offsets."""
    idx = (index if isinstance(index, int)
           else torch.as_tensor(index, device=cache["k"].device).long())
    if cache["k"].dtype == torch.int8:
        (kq, ks), (vq, vs) = _quantize_kv(k_new), _quantize_kv(v_new)
        upd = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        upd = {"k": k_new, "v": v_new}
    s_new = k_new.shape[1]
    for name, val in upd.items():
        buf = cache[name]
        val = val.to(buf.dtype)
        if isinstance(idx, int) or idx.ndim == 0:
            i = int(idx)
            buf[:, i:i + s_new] = val
        else:
            pos = idx[:, None] + torch.arange(s_new, device=buf.device)
            rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
            buf[rows, pos] = val
    return cache


def chunk_attend(params: dict, x: torch.Tensor, cfg: AttentionConfig,
                 cache: dict, offset: int, valid=None,
                 kv_chunk: int = 1024):
    """Chunked-prefill attention: an S-token chunk at sequence ``offset``
    attends the KV cache (every earlier chunk plus itself).  x: (B, S, d);
    ``valid`` (scalar or (B,)) is the prompt's real length: K/V of chunk rows
    at positions >= valid are zeroed before the cache write, so the cache
    holds what a monolithic prefill leaves there.  Chunks arrive in order
    from offset 0; the causal mask keeps positions past the chunk out.
    The chunk attends the cache's whole width in K/V blocks of
    ``kv_chunk`` (``flash_attention``).  Returns (out (B, S, d), cache
    updated in place)."""
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
    out = flash_attention(q, ck, cv, cfg, q_pos, k_pos, kv_chunk)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return _out_proj(out, params, cfg, x.dtype), cache


def _as_compute(t: torch.Tensor) -> torch.Tensor:
    """Cache operand of a decode product as float32: int8 values are read
    as bfloat16, as the reference multiplies them (exact either way)."""
    if t.dtype == torch.int8:
        return t.to(torch.bfloat16).float()
    return t.float()


def decode_scores(q, cache_k, cfg: AttentionConfig):
    """q (B, 1, H, hd) vs cache (B, S, K, hd) -> float32 scores
    (B, K, rep, S), scaled and softcapped, unmasked.

    The reference multiplies in the cache's dtype (bfloat16 for an int8
    cache) with float32 accumulation; here both operands are rounded to that
    dtype and multiplied in float32, where their products are exact, so the
    two differ only in summation order."""
    b, _, h, hd = q.shape
    kvh = cfg.n_kv_heads
    op_dtype = torch.bfloat16 if cache_k.dtype == torch.int8 \
        else cache_k.dtype
    qg = q.reshape(b, kvh, h // kvh, hd).to(op_dtype).float()
    s = torch.einsum("bkrh,btkh->bkrt", qg,
                     _as_compute(cache_k)) * (hd ** -0.5)
    return _softcap(s, cfg)


def decode_attend_partial(q, cache_k, cache_v, cfg: AttentionConfig,
                          kv_positions: torch.Tensor, q_position,
                          k_scale=None, v_scale=None):
    """Unnormalized decode attention over the cache: (o, l, m).
    ``kv_positions`` (S,) or (B, S); ``q_position`` scalar or (B,); a key
    is live at ``kv_pos <= q_pos`` and, with a window, ``q_pos - kv_pos <
    window``.  int8 caches pass their scales, applied to the (softcapped)
    scores and folded into p, in the reference's order.
    """
    s = decode_scores(q, cache_k, cfg)                        # (B,K,rep,S)
    if k_scale is not None:
        s = s * k_scale.float().transpose(1, 2)[:, :, None, :]
    q_pos = torch.as_tensor(q_position, device=s.device)
    if q_pos.ndim:
        q_pos = q_pos[:, None]
    mask = kv_positions <= q_pos
    if cfg.window > 0:
        mask = mask & ((q_pos - kv_positions) < cfg.window)
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
    return _out_proj(out.reshape(b, 1, cfg.n_heads * cfg.head_dim), params,
                     cfg, x_dtype)


def cross_decode_attend(params: dict, x: torch.Tensor, cfg: AttentionConfig,
                        enc_k: torch.Tensor, enc_v: torch.Tensor
                        ) -> torch.Tensor:
    """Single-token cross attention against precomputed K/V (B, T, K, hd):
    every position live (all at 0, the query at 0), no window.  x:
    (B, 1, d) -> (B, 1, d)."""
    b = x.shape[0]
    q = x @ params["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
    q = q.reshape(b, 1, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
    t = enc_k.shape[1]
    o, l, _ = decode_attend_partial(
        q, enc_k, enc_v, dataclasses.replace(cfg, window=0),
        torch.zeros((t,), dtype=torch.long, device=x.device), 0)
    return finalize_decode(o, l, params, x.dtype, cfg)


def precompute_cross_kv(params: dict, enc_out: torch.Tensor,
                        cfg: AttentionConfig) -> tuple:
    """Cross-attention K/V (B, T, K, hd) of encoder states (B, T, d_kv),
    computed once a request, in ``enc_out``'s dtype."""
    b, t = enc_out.shape[0], enc_out.shape[1]
    k = enc_out @ params["wk"].to(enc_out.dtype)
    v = enc_out @ params["wv"].to(enc_out.dtype)
    if cfg.qkv_bias:
        k = k + params["bk"].to(enc_out.dtype)
        v = v + params["bv"].to(enc_out.dtype)
    k = k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = rmsnorm(params["k_norm"], k)
    return k, v


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
    cache = update_kv_cache(cache, k, v,
                            cache_len if isinstance(cache_len, int) else cl)
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

def paged_update_kv(pool: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                    table: torch.Tensor, cache_len: torch.Tensor) -> dict:
    """Write one token per slot into the pool, in place: (B, 1, K, hd) K/V
    at per-slot position ``cache_len`` lands in block
    ``table[b, pos // block]`` at row ``pos % block``.  Slots parked on the
    shared write-off block collide there; the last slot wins."""
    blk, off = ref.paged_write_target(table, cache_len, pool["k"].shape[1])
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
    attention run on the paged kernels (``ops.paged_kv_write_pair``, one
    launch that finds each slot's target in the table, then
    ``ops.paged_attention`` with the softcap and window); an int8 pool
    always takes the gather route, as in the reference, where its scale
    epilogue lives.  The kernel folds ``hd^-0.5 / softcap`` into one
    constant where the gather route scales, then divides (the reference's
    order), so with a softcap the two routes agree to float32 rounding,
    not bit for bit."""
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
        ops.paged_kv_write_pair(pool["k"], pool["v"], k[:, 0], v[:, 0],
                                table, cl)
        ctx = ops.paged_attention(q[:, 0], pool["k"], pool["v"], table, cl,
                                  softcap=cfg.softcap, window=cfg.window)
        b = x.shape[0]
        return _out_proj(ctx.reshape(b, 1, cfg.n_heads * cfg.head_dim),
                         params, cfg, x.dtype), pool
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
