"""Cross-attention VLM (llama-3.2-vision style): counterpart of
``repro/models/vision_lm.py``.  A decoder backbone with a gated
cross-attention layer every ``cross_every`` layers.

The vision frontend is a stub, as in the reference: ``images`` are
precomputed patch embeddings (B, n_image_tokens, d_model).  The layers
come in ``n_layers / cross_every`` groups of ``cross_every - 1`` self
blocks (``models.lm``'s dense block) and one gated cross block, whose
attention and MLP add ``tanh(gate) * out`` to the residual.

Params: ``{"embed", "final_norm", "self_blocks": [...], "cross_blocks":
[per group {"ln1", "attn", "gate_attn", "ln2", "mlp", "gate_mlp"}]}``
(the reference stacks each list along a leading axis); ``self_blocks[g *
(p - 1) + j]`` is layer ``g * p + j`` and ``cross_blocks[g]`` layer ``g *
p + p - 1`` for ``p = cross_every``.  Alphas (L,) or (L, B) and the
(L, B) stats are in that layer order, the cross layer last in each group.
Caches: ``{"blocks": [per self block {"k", "v"[, scales]}], "cross": [per
cross block {"k", "v"}]}``; the cross K/V (B, n_image_tokens, K, hd) in
``cfg.dtype`` and updated in place like the self caches.  There is no
paged decode for this family, as in the reference.

Public API: init_lm, forward, lm_loss, prefill, prefill_chunk,
init_caches, decode_step, prepare_sparse.  ``init_lm`` and ``init_caches``
put their tensors on the card unless the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import generator, resolve_device
from repro_torch.layers import attention as A
from repro_torch.layers import embeddings as E
from repro_torch.layers.mlp import init_mlp, mlp_apply
from repro_torch.models import common as C
from repro_torch.models import lm as LM

# the scheduler may stream vlm prompts through prefill_chunk
CHUNK_PREFILL_FAMILIES = ("vlm",)

prepare_sparse = LM.prepare_sparse


def has_sparse_mlp(cfg: ModelConfig) -> bool:
    """Every layer, self or cross, runs the sparse MLP at decode."""
    return True


def _layout(cfg: ModelConfig) -> tuple:
    """(p, n_groups): layers a group, groups."""
    if cfg.family != "vlm":
        raise NotImplementedError(
            f"{cfg.name}: models.vision_lm runs the vlm family, not "
            f"{cfg.family!r}")
    p = cfg.cross_every
    if p < 2 or cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of cross_every={p} (>= 2)")
    return p, cfg.n_layers // p


def _layers(cfg: ModelConfig):
    """The layers in order: (layer index, "self" or "cross", index in its
    list)."""
    p, n_groups = _layout(cfg)
    for g in range(n_groups):
        for j in range(p - 1):
            yield g * p + j, "self", g * (p - 1) + j
        yield g * p + p - 1, "cross", g


def _gated(gate: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``tanh(gate) * h``, the gate's tanh in float32 cast to h's dtype."""
    return torch.tanh(gate.float()).to(h.dtype) * h


def _init_cross_block(gen: torch.Generator, cfg: ModelConfig,
                      device) -> dict:
    pd = C.param_dtype(cfg)
    return {
        "ln1": C.norm_init(cfg, device),
        "attn": A.init_attention(gen, C.attn_cfg(cfg, cross=True), pd,
                                 device),
        "gate_attn": torch.zeros((), dtype=pd, device=device),
        "ln2": C.norm_init(cfg, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, pd,
                        device),
        "gate_mlp": torch.zeros((), dtype=pd, device=device),
    }


def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (raises without a GPU unless it is ``"cpu"``).  The gates
    start at 0, as the reference's: a fresh cross block adds nothing."""
    p, n_groups = _layout(cfg)
    device = resolve_device(device)
    gen = generator(device, seed)
    pd = C.param_dtype(cfg)
    params: dict[str, Any] = {
        "embed": E.init_embedding(gen, cfg.vocab_padded, cfg.d_model, pd,
                                  device),
        "final_norm": C.norm_init(cfg, device),
    }
    params["self_blocks"] = [LM._init_block(gen, cfg, device, False)
                             for _ in range(n_groups * (p - 1))]
    params["cross_blocks"] = [_init_cross_block(gen, cfg, device)
                              for _ in range(n_groups)]
    if not cfg.tie_embeddings:
        params["unembed"] = E.init_unembed(gen, cfg.vocab_padded,
                                           cfg.d_model, pd, device)
    return params


def _cross_attend(blk: dict, x: torch.Tensor, cfg: ModelConfig,
                  q_pos: torch.Tensor, images: torch.Tensor):
    """The gated cross attention over a prompt or a chunk, against the raw
    image embeddings (each row independent of the others).  Returns (x,
    (k, v))."""
    h = C.norm_apply(cfg, blk["ln1"], x)
    h, kv = A.attend(blk["attn"], h, C.attn_cfg(cfg, cross=True), q_pos,
                     return_kv=True, kv_x=images,
                     kv_positions=torch.arange(images.shape[1],
                                               device=x.device),
                     kv_chunk=cfg.attn_chunk)
    return x + _gated(blk["gate_attn"], h), kv


def _cross_block(blk: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, images: torch.Tensor):
    """One gated cross block over a prompt: gated cross attention, then
    the gated MLP (dense).  Returns (x, the cross K/V)."""
    x, kv = _cross_attend(blk, x, cfg, positions, images)
    h = C.norm_apply(cfg, blk["ln2"], x)
    return x + _gated(blk["gate_mlp"], mlp_apply(
        blk["mlp"], h, LM._mlp_sparse_cfg(cfg))), kv


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            images: torch.Tensor):
    """The training forward: tokens (B, S) and images (B, T, d) -> (final
    hidden states (B, S, d), aux 0), each block recomputed in the
    backward pass when ``cfg.remat``."""
    x = LM._embed_in(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for _, kind, i in _layers(cfg):
        if kind == "self":
            x, _, aux = C.remat(cfg, LM._block_fwd, params["self_blocks"][i],
                                x, cfg, positions, cfg.window, None, aux)
        else:
            x, _ = C.remat(cfg, _cross_block, params["cross_blocks"][i], x,
                           cfg, positions, images)
    return C.norm_apply(cfg, params["final_norm"], x), aux


def lm_loss(params: dict, cfg: ModelConfig, batch: dict):
    """batch ``{"tokens", "labels", "images"}`` -> (loss, ``{"xent",
    "aux"}``), as ``models.lm.lm_loss``."""
    hidden, aux = forward(params, cfg, batch["tokens"], batch["images"])
    xent = C.chunked_xent(hidden, batch["labels"], LM._head_table(params),
                          cfg.final_softcap, cfg.loss_chunk)
    return xent + aux, {"xent": xent, "aux": aux}


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            images: torch.Tensor, max_len: int):
    """Prompt pass building the caches.  tokens (B, S), images (B, T, d)
    -> (next-token logits (B, V) float32, caches); the cross K/V as the
    attention computed them."""
    dev = tokens.device
    x = LM._embed_in(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=dev)
    kv_dt = C.torch_dtype(cfg.kv_cache_dtype)
    selfc, cross = [], []
    for _, kind, i in _layers(cfg):
        if kind == "self":
            x, (k, v), _ = LM._block_fwd(params["self_blocks"][i], x,
                                         cfg, positions, cfg.window)
            cache = A.init_kv_cache(tokens.shape[0], max_len,
                                    C.attn_cfg(cfg), kv_dt, dev)
            selfc.append(A.update_kv_cache(cache, k, v, 0))
            continue
        x, (ck, cv) = _cross_block(params["cross_blocks"][i], x, cfg,
                                   positions, images)
        cross.append({"k": ck, "v": cv})
    x = C.norm_apply(cfg, params["final_norm"], x)
    logits = C.head_logits(x[:, -1], LM._head_table(params),
                           cfg.final_softcap)
    return logits, {"blocks": selfc, "cross": cross}


def prefill_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  caches: dict, offset: int, valid, images: torch.Tensor,
                  *, alphas=None, collect_stats: bool = False):
    """One fixed-size prefill chunk: the contract of
    ``models.lm.prefill_chunk``.  Self blocks stream K/V into the cache;
    the gated cross blocks re-run attention over the raw image embeddings
    and write the same cross K/V on every chunk, cast to the cache's
    dtype."""
    _layout(cfg)
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
    for layer, kind, i in _layers(cfg):
        if kind == "self":
            x, _, st = LM._block_chunk_fwd(
                params["self_blocks"][i], x, cfg, caches["blocks"][i],
                offset, vld, cfg.window, alphas[layer], tok_mask,
                collect_stats)
        else:
            blk, cc = params["cross_blocks"][i], caches["cross"][i]
            x, (ck, cv) = _cross_attend(blk, x, cfg, pos, images)
            cc["k"].copy_(ck)
            cc["v"].copy_(cv)
            h = C.norm_apply(cfg, blk["ln2"], x)
            out, st = LM._chunk_mlp(blk["mlp"], h, cfg, alphas[layer],
                                    tok_mask, collect_stats)
            x = x + _gated(blk["gate_mlp"], out)
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
    ``"cpu"``): a self cache in ``kv_cache_dtype`` a self block, the cross
    K/V (batch, n_image_tokens, K, hd) in ``cfg.dtype`` a cross block."""
    p, n_groups = _layout(cfg)
    device = resolve_device(device)
    kv_dt = C.torch_dtype(cfg.kv_cache_dtype)
    shape = (batch, cfg.n_image_tokens, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dt = C.compute_dtype(cfg)
    return {
        "blocks": [A.init_kv_cache(batch, max_len, C.attn_cfg(cfg), kv_dt,
                                   device)
                   for _ in range(n_groups * (p - 1))],
        "cross": [{"k": torch.zeros(shape, dtype=dt, device=device),
                   "v": torch.zeros(shape, dtype=dt, device=device)}
                  for _ in range(n_groups)],
    }


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                caches: dict, cache_len, *, alphas=None,
                collect_stats: bool = False, block_table=None):
    """One decode step: the contract of ``models.lm.decode_step`` (alphas
    (L,) or (L, B) and stats (L, B) in layer order, with the per-shard
    riders under ``tp_shards``).  The cross blocks read the cross caches,
    which they leave as they are.  There is no paged decode for this
    family: ``block_table`` must be None."""
    _layout(cfg)
    if block_table is not None:
        raise NotImplementedError("vlm has no paged KV decode (the "
                                  "reference has none)")
    x = LM._embed_in(params, cfg, token)
    alphas = torch.as_tensor(LM._alphas(cfg) if alphas is None else alphas,
                             dtype=torch.float32, device=x.device)
    if alphas.shape[0] != cfg.n_layers:
        raise ValueError(f"alphas {tuple(alphas.shape)}: need n_layers="
                         f"{cfg.n_layers} rows")
    ccfg = C.attn_cfg(cfg, cross=True)
    stats = []
    for layer, kind, i in _layers(cfg):
        if kind == "self":
            x, _, st = LM._block_decode(
                params["self_blocks"][i], x, cfg, caches["blocks"][i],
                cache_len, cfg.window, alphas[layer],
                collect_stats=collect_stats)
        else:
            blk, cc = params["cross_blocks"][i], caches["cross"][i]
            h = C.norm_apply(cfg, blk["ln1"], x)
            h = A.cross_decode_attend(blk["attn"], h, ccfg, cc["k"], cc["v"])
            x = x + _gated(blk["gate_attn"], h)
            h = C.norm_apply(cfg, blk["ln2"], x)
            out = mlp_apply(blk["mlp"], h, LM._mlp_sparse_cfg(cfg),
                            decode=True, alpha=alphas[layer],
                            return_stats=collect_stats)
            st = None
            if collect_stats:
                out, st = out
            x = x + _gated(blk["gate_mlp"], out)
        stats.append(st)
    x = C.norm_apply(cfg, params["final_norm"], x)
    logits = C.head_logits(x[:, 0], LM._head_table(params),
                           cfg.final_softcap)
    if collect_stats:
        return logits, caches, LM._stack_stats(stats)
    return logits, caches
