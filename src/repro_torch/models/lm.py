"""Decoder-only LM, dense family: counterpart of ``repro/models/lm.py``.

Every dense arch of the reference runs: GQA/MQA, QKV bias, qk-norm,
gemma2's alternating local (sliding-window) and global layers, attention
and final logit softcaps, post-block norms and the embedding scale; gated
and ungated MLPs.  ``first_dense_layers`` (a moe setting) is not ported.

Params are dicts of tensors; the layer stack is a list of per-layer block
dicts (the reference stacks them along a leading axis for ``lax.scan``; a
Python loop over layers takes the scan's place).  Caches are
``{"blocks": [per-layer {"k", "v"[, "k_scale", "v_scale"]}]}``.

Public API: init_lm, init_caches, init_kv_pool, prefill, prefill_chunk,
decode_step, prepare_sparse.  ``init_lm``, ``init_caches`` and
``init_kv_pool`` put their tensors on the card unless the caller asks for
``device="cpu"``.  A paged KV pool has the caches' layout with each leaf's
(batch, max_len) dims replaced by (n_blocks, block_size); ``decode_step``
takes it with ``block_table=``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparse_mlp as SM
from repro_torch.device import resolve_device
from repro_torch.layers import attention as A
from repro_torch.layers import embeddings as E
from repro_torch.layers.mlp import init_mlp, mlp_apply
from repro_torch.models import common as C


# ModelConfig flavours the port does not run yet (they arrive with the
# families that use them): a config that sets one is rejected, not run wrong
_UNPORTED = ("first_dense_layers",)

# families whose prefill runs in fixed-size chunks against the decode cache
CHUNK_PREFILL_FAMILIES = ("dense",)

# families whose caches are pure per-layer KV and can live in the paged
# block pool
PAGED_KV_FAMILIES = ("dense",)


def _check_family(cfg: ModelConfig) -> None:
    unported = [f for f in _UNPORTED if getattr(cfg, f)]
    if cfg.family != "dense" or cfg.norm != "rmsnorm" or unported:
        raise NotImplementedError(
            f"{cfg.name}: only the plain dense family is ported (ROADMAP "
            f"Queue A, other model families); unported settings "
            f"{unported or [cfg.family, cfg.norm]}")


def _windows(cfg: ModelConfig) -> tuple:
    """Sliding window per position of the layer pattern: gemma2 alternates
    local (``cfg.window``) and global (0) layers; layer ``i`` takes
    ``windows[i % len(windows)]``."""
    if cfg.local_global_period:
        return tuple(cfg.window if i % 2 == 0 else 0
                     for i in range(cfg.local_global_period))
    return (cfg.window,)


def _layer_windows(cfg: ModelConfig) -> list:
    w = _windows(cfg)
    return [w[i % len(w)] for i in range(cfg.n_layers)]


def _mlp_sparse_cfg(cfg: ModelConfig) -> SM.SparseInferConfig:
    act = cfg.sparse.activation if cfg.sparse.enabled else cfg.activation
    return dataclasses.replace(cfg.sparse, activation=act)


def _alphas(cfg: ModelConfig) -> np.ndarray:
    return cfg.sparse.alpha_schedule().alphas(cfg.n_layers)


def _init_block(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    pd = C.param_dtype(cfg)
    blk = {
        "ln1": C.norm_init(cfg, device),
        "attn": A.init_attention(gen, C.attn_cfg(cfg), pd, device),
        "ln2": C.norm_init(cfg, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, pd,
                        device),
    }
    if cfg.post_block_norm:
        blk["ln1_post"] = C.norm_init(cfg, device)
        blk["ln2_post"] = C.norm_init(cfg, device)
    return blk


def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the draws differ from the reference's
    ``jax.random``; tests carry the reference's weights over with
    ``repro_torch.bridge``).  Raises without a GPU unless ``device`` is
    ``"cpu"``."""
    _check_family(cfg)
    if cfg.n_layers % len(_windows(cfg)):
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of local_global_period="
                         f"{cfg.local_global_period}")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    pd = C.param_dtype(cfg)
    params: dict[str, Any] = {
        "embed": E.init_embedding(gen, cfg.vocab_padded, cfg.d_model, pd,
                                  device),
        "final_norm": C.norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = E.init_unembed(gen, cfg.vocab_padded,
                                           cfg.d_model, pd, device)
    params["blocks"] = [_init_block(gen, cfg, device)
                        for _ in range(cfg.n_layers)]
    return params


def _head_table(params: dict) -> torch.Tensor:
    return params.get("unembed", params["embed"])["table"]


def _embed_in(params: dict, cfg: ModelConfig, tokens: torch.Tensor):
    return E.embed(params["embed"], tokens, cfg.embed_scale,
                   C.compute_dtype(cfg))


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda") -> dict:
    """Zero decode caches, one KV dict per layer, on ``device`` (raises
    without a GPU unless it is ``"cpu"``)."""
    _check_family(cfg)
    device = resolve_device(device)
    kv_dt = C.torch_dtype(cfg.kv_cache_dtype)
    return {"blocks": [A.init_kv_cache(batch, max_len, C.attn_cfg(cfg),
                                       kv_dt, device)
                       for _ in range(cfg.n_layers)]}


def init_kv_pool(cfg: ModelConfig, n_blocks: int, block_size: int,
                 device="cuda") -> dict:
    """Zero paged-KV block pool: per layer ``{"k", "v"}`` of shape
    (n_blocks, block_size, K, hd) (+ (n_blocks, block_size, K) bfloat16
    scales for an int8 pool), shared by every slot through per-slot block
    tables.  On ``device`` (raises without a GPU unless it is ``"cpu"``)."""
    if cfg.family not in PAGED_KV_FAMILIES:
        raise NotImplementedError(
            f"paged KV pool supports {PAGED_KV_FAMILIES}, not "
            f"{cfg.family!r}")
    return init_caches(cfg, n_blocks, block_size, device)


def _post_norm(cfg: ModelConfig, blk: dict, name: str, h: torch.Tensor):
    """gemma2's norm on a sublayer's output before the residual add."""
    if cfg.post_block_norm:
        return C.norm_apply(cfg, blk[name], h)
    return h


def _block_fwd(blk: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, window: int):
    """One transformer block over a prompt (dense MLP).  Returns (x, kv)."""
    h = C.norm_apply(cfg, blk["ln1"], x)
    h, kv = A.attend(blk["attn"], h, C.attn_cfg(cfg, window), positions,
                     return_kv=True)
    x = x + _post_norm(cfg, blk, "ln1_post", h)
    h = C.norm_apply(cfg, blk["ln2"], x)
    h = mlp_apply(blk["mlp"], h, _mlp_sparse_cfg(cfg))
    return x + _post_norm(cfg, blk, "ln2_post", h), kv


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int):
    """Prompt pass building decode caches.  tokens (B, S) -> (next-token
    logits (B, V) float32, caches)."""
    _check_family(cfg)
    dev = tokens.device
    x = _embed_in(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=dev)
    kv_dt = C.torch_dtype(cfg.kv_cache_dtype)
    caches = []
    for blk, window in zip(params["blocks"], _layer_windows(cfg)):
        x, (k, v) = _block_fwd(blk, x, cfg, positions, window)
        cache = A.init_kv_cache(tokens.shape[0], max_len, C.attn_cfg(cfg),
                                kv_dt, dev)
        caches.append(A.update_kv_cache(cache, k, v, 0))
    x = C.norm_apply(cfg, params["final_norm"], x)
    logits = C.head_logits(x[:, -1], _head_table(params), cfg.final_softcap)
    return logits, {"blocks": caches}


def _block_decode(blk: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                  cache_len, window: int, alpha, collect_stats: bool = False,
                  block_table=None):
    """One block, single-token decode.  Returns (x, cache, stats or None).
    ``block_table`` switches the attention onto the paged KV pool
    (``cache`` is then this layer's pool leaves)."""
    h = C.norm_apply(cfg, blk["ln1"], x)
    acfg = C.attn_cfg(cfg, window)
    if block_table is not None:
        h, cache = A.paged_decode_attend(blk["attn"], h, acfg, cache,
                                         cache_len, block_table)
    else:
        h, cache = A.decode_attend(blk["attn"], h, acfg, cache, cache_len)
    x = x + _post_norm(cfg, blk, "ln1_post", h)
    h = C.norm_apply(cfg, blk["ln2"], x)
    out = mlp_apply(blk["mlp"], h, _mlp_sparse_cfg(cfg), decode=True,
                    alpha=alpha, return_stats=collect_stats)
    stats = None
    if collect_stats:
        out, stats = out
    return x + _post_norm(cfg, blk, "ln2_post", out), cache, stats


def _dense_stack_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                        caches: dict, cache_len, alphas=None,
                        collect_stats: bool = False, block_table=None):
    """Decode through every layer.  ``alphas`` overrides the static
    schedule: (n_layers,) per layer or (n_layers, B) per layer and slot.
    ``block_table`` (B, nbps): paged-KV mode, ``caches`` is then the block
    pool (``init_kv_pool``), its table shared by every layer."""
    alphas = torch.as_tensor(_alphas(cfg) if alphas is None else alphas,
                             dtype=torch.float32, device=x.device)
    if alphas.shape[0] != cfg.n_layers:
        raise ValueError(f"alphas {tuple(alphas.shape)}: need n_layers="
                         f"{cfg.n_layers} rows")
    new, stats = [], []
    for i, (blk, cache, window) in enumerate(zip(
            params["blocks"], caches["blocks"], _layer_windows(cfg))):
        x, cache, st = _block_decode(blk, x, cfg, cache, cache_len, window,
                                     alphas[i], collect_stats=collect_stats,
                                     block_table=block_table)
        new.append(cache)
        stats.append(st)
    if collect_stats:
        return x, {"blocks": new}, _stack_stats(stats)
    return x, {"blocks": new}, None


def _stack_stats(stats: list) -> dict:
    """Per-layer MLP stats -> (L, B, ...) tensors: the ``MLP_STAT_KEYS``
    (L, B) and, for a tensor-sharded config, the per-shard riders
    (L, B, tp_shards)."""
    return {k: torch.stack([s[k] for s in stats]) for k in stats[0]}


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                caches: dict, cache_len, *, alphas=None,
                collect_stats: bool = False, block_table=None):
    """One decode step.  token (B, 1) -> (logits (B, V) float32, caches
    [, stats]).  ``cache_len``: scalar shared length or (B,) per-slot
    lengths.  With ``collect_stats`` the stats are a dict over
    ``MLP_STAT_KEYS`` of (L, B) float32 tensors, and with ``tp_shards``
    also the per-shard riders (L, B, tp_shards).  ``block_table``
    (B, nbps) int32: ``caches`` is a paged KV pool (``init_kv_pool``) and
    ``cache_len`` must be per slot."""
    _check_family(cfg)
    if block_table is not None and cfg.family not in PAGED_KV_FAMILIES:
        raise NotImplementedError(
            f"paged KV decode supports {PAGED_KV_FAMILIES}, not "
            f"{cfg.family!r}")
    x = _embed_in(params, cfg, token)
    x, caches, stats = _dense_stack_decode(params, x, cfg, caches, cache_len,
                                           alphas, collect_stats,
                                           block_table)
    x = C.norm_apply(cfg, params["final_norm"], x)
    logits = C.head_logits(x[:, 0], _head_table(params), cfg.final_softcap)
    if collect_stats:
        return logits, caches, stats
    return logits, caches


def _chunk_stat_mean(a: torch.Tensor, tok_mask: torch.Tensor):
    """One chunk's per-row MLP stats, (B*S, ...) from the sparse path or
    (B, S, ...) from the dense one (``...``: a sharded config's shard
    axis), reduced to (B, ...): the mean over the chunk's real prompt
    positions only (pad rows carry dead-alpha values)."""
    b, s = tok_mask.shape
    if tuple(a.shape[:2]) != (b, s):
        a = a.reshape((b, s) + tuple(a.shape[1:]))
    wm = tok_mask.float().reshape((b, s) + (1,) * (a.ndim - 2))
    return (a * wm).sum(1) / torch.clamp(wm.sum(1), min=1.0)


def _block_chunk_fwd(blk: dict, x: torch.Tensor, cfg: ModelConfig,
                     cache: dict, offset: int, valid, window: int, alpha,
                     tok_mask, collect_stats: bool = False):
    """One block over a prefill chunk, writing K/V into the decode cache at
    ``offset``.  ``tok_mask`` (B, S) marks real prompt positions: pad rows
    enter the sparse union with ``DEAD_SLOT_ALPHA`` (they predict
    all-sparse and leave the chunk union) and stay out of the stats."""
    h = C.norm_apply(cfg, blk["ln1"], x)
    h, cache = A.chunk_attend(blk["attn"], h, C.attn_cfg(cfg, window), cache,
                              offset, valid)
    x = x + _post_norm(cfg, blk, "ln1_post", h)
    h = C.norm_apply(cfg, blk["ln2"], x)
    al = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    if al.ndim == 1:                                       # per slot (B,)
        al = al[:, None]
    a_tok = torch.where(tok_mask, al, torch.tensor(
        SM.DEAD_SLOT_ALPHA, device=x.device)).reshape(-1)
    out = mlp_apply(blk["mlp"], h, _mlp_sparse_cfg(cfg), prefill=True,
                    alpha=a_tok, return_stats=collect_stats)
    stats = None
    if collect_stats:
        out, st = out
        stats = {k: _chunk_stat_mean(v, tok_mask) for k, v in st.items()}
    return x + _post_norm(cfg, blk, "ln2_post", out), cache, stats


def _dense_stack_chunk(params: dict, x: torch.Tensor, cfg: ModelConfig,
                       caches: dict, offset: int, valid, tok_mask,
                       alphas=None, collect_stats: bool = False):
    """A prefill chunk through every layer; alphas as in
    ``_dense_stack_decode``: (n_layers,) or (n_layers, B)."""
    alphas = torch.as_tensor(_alphas(cfg) if alphas is None else alphas,
                             dtype=torch.float32, device=x.device)
    new, stats = [], []
    for i, (blk, cache, window) in enumerate(zip(
            params["blocks"], caches["blocks"], _layer_windows(cfg))):
        x, cache, st = _block_chunk_fwd(blk, x, cfg, cache, offset, valid,
                                        window, alphas[i], tok_mask,
                                        collect_stats)
        new.append(cache)
        stats.append(st)
    if collect_stats:
        return x, {"blocks": new}, _stack_stats(stats)
    return x, {"blocks": new}, None


def prefill_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  caches: dict, offset: int, valid, *, alphas=None,
                  collect_stats: bool = False):
    """One fixed-size prefill chunk against decode-layout caches.

    tokens (B, S): the chunk of the prompt that starts at sequence
    ``offset``; ``valid`` (scalar or (B,)): the prompt's real length, so
    chunk positions >= valid are padding.  Chunks arrive in order from
    offset 0; ``caches`` (``init_caches``) are updated in place.  Returns
    (logits (B, V) float32 read at position ``valid - 1``, meaningful on
    the chunk that holds it, caches[, stats]); stats are the (L, B) MLP
    telemetry of ``decode_step``, averaged over the chunk's real rows."""
    if cfg.family not in CHUNK_PREFILL_FAMILIES:
        raise NotImplementedError(
            f"chunked prefill supports {CHUNK_PREFILL_FAMILIES}, not "
            f"{cfg.family!r}")
    _check_family(cfg)
    dev = tokens.device
    b, s = tokens.shape
    offset = int(offset)
    vld = torch.as_tensor(valid, dtype=torch.long, device=dev)
    if vld.ndim == 0:
        vld = vld.expand(b)
    pos = offset + torch.arange(s, device=dev)
    tok_mask = pos[None, :] < vld[:, None]                    # (B, S)
    x = _embed_in(params, cfg, tokens)
    x, caches, stats = _dense_stack_chunk(params, x, cfg, caches, offset,
                                          vld, tok_mask, alphas,
                                          collect_stats)
    x = C.norm_apply(cfg, params["final_norm"], x)
    last = torch.clamp(vld - 1 - offset, 0, s - 1)            # (B,)
    logits = C.head_logits(x[torch.arange(b, device=dev), last],
                           _head_table(params), cfg.final_softcap)
    if collect_stats:
        return logits, caches, stats
    return logits, caches


def prepare_sparse(params: dict, sparse: Optional[SM.SparseInferConfig] = None
                   ) -> dict:
    """Offline step for serving: pack each layer's gate-weight sign bits;
    with ``sparse.weight_dtype == "int8"`` also quantize each layer's MLP
    (``core/quantize.py``).  A node already quantized passes through."""
    out = dict(params)
    out["blocks"] = [dict(blk, mlp=SM.prepare_sparse_params(blk["mlp"],
                                                            sparse))
                     if "wg_t" in blk["mlp"] else blk
                     for blk in params["blocks"]]
    return out
