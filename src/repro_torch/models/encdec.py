"""Encoder-decoder (seamless-m4t style): counterpart of
``repro/models/encdec.py``.  An audio encoder and an autoregressive text
decoder with cross attention to the encoder's states.

The audio frontend is a stub, as in the reference: ``frames`` are
precomputed frame embeddings (B, n_frames, d_model).  LayerNorm and
ungated ReLU FFNs, so the technique applies to the decoder FFNs at decode
directly (the paper covers Falcon/OPT-style plain MLPs, §III).  The
encoder is non-causal and its FFNs run dense; it runs once a request (a
chunked prefill takes its output precomputed).

Params: ``{"embed", "enc_blocks": [per encoder layer {"ln1", "attn",
"ln2", "mlp"}], "dec_blocks": [per decoder layer {"ln1", "attn", "ln_x",
"cross", "ln2", "mlp"}], "enc_norm", "final_norm"}`` (the reference stacks
each block list along a leading axis).  Caches: ``{"blocks": [per decoder
layer {"k", "v"[, "k_scale", "v_scale"]}], "cross": [per decoder layer
{"k", "v"}]}``; the self caches are in ``kv_cache_dtype``, the cross K/V
(B, n_frames, K, hd) in ``cfg.dtype``.  Like ``models.lm``, the caches
are updated in place.  There is no paged decode for this family, as in the
reference.

Public API: init_lm, encode, forward, lm_loss, prefill, prefill_chunk,
init_caches, decode_step, prepare_sparse.  ``init_lm`` and ``init_caches``
put their tensors on the card unless the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import generator, resolve_device
from repro_torch.layers import attention as A
from repro_torch.layers import embeddings as E
from repro_torch.layers.mlp import init_mlp, mlp_apply
from repro_torch.models import common as C
from repro_torch.models import lm as LM

# the scheduler may stream decoder prompts through prefill_chunk; the
# encoder runs once an admission (the server passes its output to every
# chunk)
CHUNK_PREFILL_FAMILIES = ("encdec",)

prepare_sparse = LM.prepare_sparse


def has_sparse_mlp(cfg: ModelConfig) -> bool:
    """Every decoder layer runs the sparse MLP at decode."""
    return True


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "encdec":
        raise NotImplementedError(
            f"{cfg.name}: models.encdec runs the encdec family, not "
            f"{cfg.family!r}")


def _init_enc_block(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    pd = C.param_dtype(cfg)
    return {
        "ln1": C.norm_init(cfg, device),
        "attn": A.init_attention(gen, C.attn_cfg(cfg), pd, device),
        "ln2": C.norm_init(cfg, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, pd,
                        device),
    }


def _init_dec_block(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    pd = C.param_dtype(cfg)
    return {
        "ln1": C.norm_init(cfg, device),
        "attn": A.init_attention(gen, C.attn_cfg(cfg), pd, device),
        "ln_x": C.norm_init(cfg, device),
        "cross": A.init_attention(gen, C.attn_cfg(cfg, cross=True), pd,
                                  device),
        "ln2": C.norm_init(cfg, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, pd,
                        device),
    }


def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (raises without a GPU unless it is ``"cpu"``)."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = generator(device, seed)
    pd = C.param_dtype(cfg)
    params: dict[str, Any] = {
        "embed": E.init_embedding(gen, cfg.vocab_padded, cfg.d_model, pd,
                                  device)}
    params["enc_blocks"] = [_init_enc_block(gen, cfg, device)
                            for _ in range(cfg.n_enc_layers)]
    params["dec_blocks"] = [_init_dec_block(gen, cfg, device)
                            for _ in range(cfg.n_layers)]
    params["enc_norm"] = C.norm_init(cfg, device)
    params["final_norm"] = C.norm_init(cfg, device)
    return params


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames (B, T, d) stub embeddings -> encoder states (B, T, d) in
    ``cfg.dtype``: non-causal self-attention (RoPE on), dense FFNs.  In
    training each block is recomputed in the backward pass when
    ``cfg.remat``."""
    _check_family(cfg)
    x = frames.to(C.compute_dtype(cfg))
    positions = torch.arange(frames.shape[1], device=frames.device)
    acfg = dataclasses.replace(C.attn_cfg(cfg), causal=False)
    for blk in params["enc_blocks"]:
        x = C.remat(cfg, _enc_block, blk, x, cfg, acfg, positions)
    return C.norm_apply(cfg, params["enc_norm"], x)


def _enc_block(blk: dict, x: torch.Tensor, cfg: ModelConfig, acfg,
               positions: torch.Tensor) -> torch.Tensor:
    h = C.norm_apply(cfg, blk["ln1"], x)
    x = x + A.attend(blk["attn"], h, acfg, positions,
                     kv_chunk=cfg.attn_chunk)
    h = C.norm_apply(cfg, blk["ln2"], x)
    return x + mlp_apply(blk["mlp"], h, LM._mlp_sparse_cfg(cfg))


def _cross_attend(blk: dict, x: torch.Tensor, cfg: ModelConfig,
                  q_pos: torch.Tensor, enc_out: torch.Tensor):
    """The decoder block's cross attention over a prompt or a chunk (each
    row independent of the others).  Returns (out, (k, v))."""
    h = C.norm_apply(cfg, blk["ln_x"], x)
    return A.attend(blk["cross"], h, C.attn_cfg(cfg, cross=True), q_pos,
                    return_kv=True, kv_x=enc_out,
                    kv_positions=torch.arange(enc_out.shape[1],
                                              device=x.device),
                    kv_chunk=cfg.attn_chunk)


def _dec_block(blk: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, enc_out: torch.Tensor):
    """One decoder block over a prompt: self attention, cross attention to
    ``enc_out``, the FFN (dense).  Returns (x, its self K/V, its cross
    K/V)."""
    h = C.norm_apply(cfg, blk["ln1"], x)
    h, kv = A.attend(blk["attn"], h, C.attn_cfg(cfg), positions,
                     return_kv=True, kv_chunk=cfg.attn_chunk)
    x = x + h
    h, ckv = _cross_attend(blk, x, cfg, positions, enc_out)
    x = x + h
    h = C.norm_apply(cfg, blk["ln2"], x)
    return x + mlp_apply(blk["mlp"], h, LM._mlp_sparse_cfg(cfg)), kv, ckv


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor):
    """The training forward: encode ``frames`` (B, T, d), then the
    decoder over tokens (B, S) -> (final hidden states (B, S, d), aux 0).
    Each decoder block (self attention, cross attention, the dense FFN)
    is recomputed in the backward pass when ``cfg.remat``."""
    _check_family(cfg)
    enc_out = encode(params, cfg, frames)
    x = LM._embed_in(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for blk in params["dec_blocks"]:
        x = C.remat(cfg, _dec_block, blk, x, cfg, positions, enc_out)[0]
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return C.norm_apply(cfg, params["final_norm"], x), aux


def lm_loss(params: dict, cfg: ModelConfig, batch: dict):
    """batch ``{"tokens", "labels", "frames"}`` -> (loss, ``{"xent",
    "aux"}``), as ``models.lm.lm_loss``."""
    hidden, aux = forward(params, cfg, batch["tokens"], batch["frames"])
    xent = C.chunked_xent(hidden, batch["labels"], LM._head_table(params),
                          cfg.final_softcap, cfg.loss_chunk)
    return xent + aux, {"xent": xent, "aux": aux}


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor, max_len: int):
    """Encode, then the decoder's prompt pass building the caches.  tokens
    (B, S), frames (B, T, d) -> (next-token logits (B, V) float32,
    caches); the cross K/V as the attention computed them."""
    _check_family(cfg)
    enc_out = encode(params, cfg, frames)
    dev = tokens.device
    x = LM._embed_in(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=dev)
    kv_dt = C.torch_dtype(cfg.kv_cache_dtype)
    selfc, cross = [], []
    for blk in params["dec_blocks"]:
        x, (k, v), (ck, cv) = _dec_block(blk, x, cfg, positions, enc_out)
        cache = A.init_kv_cache(tokens.shape[0], max_len, C.attn_cfg(cfg),
                                kv_dt, dev)
        selfc.append(A.update_kv_cache(cache, k, v, 0))
        cross.append({"k": ck, "v": cv})
    x = C.norm_apply(cfg, params["final_norm"], x)
    logits = C.head_logits(x[:, -1], LM._head_table(params),
                           cfg.final_softcap)
    return logits, {"blocks": selfc, "cross": cross}


def prefill_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  caches: dict, offset: int, valid, enc_out: torch.Tensor,
                  *, alphas=None, collect_stats: bool = False):
    """One fixed-size decoder prefill chunk: the contract of
    ``models.lm.prefill_chunk``, with ``enc_out`` (B, T, d) the encoder's
    output, computed once (``encode``) and passed to every chunk.  Self
    attention streams K/V into ``caches["blocks"]`` at ``offset``; cross
    attention re-runs against ``enc_out`` and writes the same cross K/V on
    every chunk, cast to the cache's dtype."""
    _check_family(cfg)
    dev = tokens.device
    b, s = tokens.shape
    offset = int(offset)
    vld = torch.as_tensor(valid, dtype=torch.long, device=dev)
    if vld.ndim == 0:
        vld = vld.expand(b)
    pos = offset + torch.arange(s, device=dev)
    tok_mask = pos[None, :] < vld[:, None]                    # (B, S)
    alphas = torch.as_tensor(LM._alphas(cfg) if alphas is None else alphas,
                             dtype=torch.float32, device=dev)
    x = LM._embed_in(params, cfg, tokens)
    stats = []
    for i, (blk, cache, cc) in enumerate(zip(
            params["dec_blocks"], caches["blocks"], caches["cross"])):
        h = C.norm_apply(cfg, blk["ln1"], x)
        h, _ = A.chunk_attend(blk["attn"], h, C.attn_cfg(cfg), cache,
                              offset, vld, kv_chunk=cfg.attn_chunk)
        x = x + h
        h, (ck, cv) = _cross_attend(blk, x, cfg, pos, enc_out)
        x = x + h
        cc["k"].copy_(ck)
        cc["v"].copy_(cv)
        h = C.norm_apply(cfg, blk["ln2"], x)
        out, st = LM._chunk_mlp(blk["mlp"], h, cfg, alphas[i], tok_mask,
                                collect_stats)
        x = x + out
        stats.append(st)
    x = C.norm_apply(cfg, params["final_norm"], x)
    last = torch.clamp(vld - 1 - offset, 0, s - 1)            # (B,)
    logits = C.head_logits(x[torch.arange(b, device=dev), last],
                           LM._head_table(params), cfg.final_softcap)
    if collect_stats:
        return logits, caches, LM._stack_stats(stats)
    return logits, caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda") -> dict:
    """Zero decode caches on ``device`` (raises without a GPU unless it is
    ``"cpu"``): the self caches in ``kv_cache_dtype``, the cross K/V
    (batch, n_frames, K, hd) in ``cfg.dtype``."""
    _check_family(cfg)
    device = resolve_device(device)
    kv_dt = C.torch_dtype(cfg.kv_cache_dtype)
    shape = (batch, cfg.n_frames, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = C.compute_dtype(cfg)
    return {
        "blocks": [A.init_kv_cache(batch, max_len, C.attn_cfg(cfg), kv_dt,
                                   device) for _ in range(cfg.n_layers)],
        "cross": [{"k": torch.zeros(shape, dtype=dt, device=device),
                   "v": torch.zeros(shape, dtype=dt, device=device)}
                  for _ in range(cfg.n_layers)],
    }


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                caches: dict, cache_len, *, alphas=None,
                collect_stats: bool = False, block_table=None):
    """One decoder step: the contract of ``models.lm.decode_step`` (alphas
    (L,) or (L, B) over the decoder layers; stats (L, B), with the
    per-shard riders under ``tp_shards``).  Cross attention reads the
    cross caches, which it leaves as they are.  There is no paged decode
    for this family: ``block_table`` must be None."""
    _check_family(cfg)
    if block_table is not None:
        raise NotImplementedError("encdec has no paged KV decode (the "
                                  "reference has none)")
    x = LM._embed_in(params, cfg, token)
    alphas = torch.as_tensor(LM._alphas(cfg) if alphas is None else alphas,
                             dtype=torch.float32, device=x.device)
    if alphas.shape[0] != cfg.n_layers:
        raise ValueError(f"alphas {tuple(alphas.shape)}: need n_layers="
                         f"{cfg.n_layers} rows")
    ccfg = C.attn_cfg(cfg, cross=True)
    stats = []
    for i, (blk, cache, cc) in enumerate(zip(
            params["dec_blocks"], caches["blocks"], caches["cross"])):
        h = C.norm_apply(cfg, blk["ln1"], x)
        h, _ = A.decode_attend(blk["attn"], h, C.attn_cfg(cfg), cache,
                               cache_len)
        x = x + h
        h = C.norm_apply(cfg, blk["ln_x"], x)
        x = x + A.cross_decode_attend(blk["cross"], h, ccfg, cc["k"],
                                      cc["v"])
        h = C.norm_apply(cfg, blk["ln2"], x)
        out = mlp_apply(blk["mlp"], h, LM._mlp_sparse_cfg(cfg), decode=True,
                        alpha=alphas[i], return_stats=collect_stats)
        if collect_stats:
            out, st = out
            stats.append(st)
        x = x + out
    x = C.norm_apply(cfg, params["final_norm"], x)
    logits = C.head_logits(x[:, 0], LM._head_table(params),
                           cfg.final_softcap)
    if collect_stats:
        return logits, caches, LM._stack_stats(stats)
    return logits, caches
