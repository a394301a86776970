"""Decoder-only LM, the dense, moe, hybrid and xlstm families:
counterpart of ``repro/models/lm.py``.  The cross-attention families run
through ``models/encdec.py`` and ``models/vision_lm.py``, which reuse the
block helpers here as the reference's modules reuse ``LM.*``
(``launch/specs.py:model_module`` picks the module of a config).

Every family runs with RMSNorm or LayerNorm (``cfg.norm``), as the
reference's blocks pick it.  Every dense arch of the reference runs:
GQA/MQA, QKV bias, qk-norm,
gemma2's alternating local (sliding-window) and global layers, attention
and final logit softcaps, post-block norms and the embedding scale; gated
and ungated MLPs.  The moe family (deepseek-moe, olmoe) replaces the MLP
by a routed MoE layer (``layers/moe.py``) after its ``first_dense_layers``
dense layers, which run the sparse MLP; an MoE layer reports zero MLP
stats, so the per-layer stats and alphas keep one row a layer.

The hybrid family (zamba2) runs ``n_layers // attn_every`` groups of one
shared transformer block (one set of weights, the sparse MLP included)
and ``attn_every`` Mamba2 layers (``layers/mamba2.py``), then the
remaining ``n_layers % attn_every`` Mamba2 layers as a tail.  Invocation
g of the shared block adds its own LoRA delta ``lora_a @ lora_b_q`` to
the query weights and takes alpha row g of the (n_layers,) or
(n_layers, B) alphas; its stats have one row an invocation, (n_inv, B).
The xlstm family runs ``n_layers // slstm_every`` groups of blocks in the
order mLSTM, sLSTM, mLSTM, ... (``layers/xlstm.py``); it has no MLP, so
it reads no alphas and its decode returns no stats.  Neither family has
chunked prefill or a paged KV pool, as in the reference: its recurrent
state has no offset splice and no block layout.

Params are dicts of tensors; each layer stack is a list of per-layer
dicts, in layer order (the reference stacks them along a leading axis for
``lax.scan``; a Python loop over layers takes the scan's place): dense
and moe ``blocks`` (each with an ``"mlp"`` or a ``"moe"`` node); hybrid
``mamba`` (the grouped layers, group g's at ``g * attn_every + j``),
``mamba_tail``, one ``shared`` block dict and ``lora`` (one dict an
invocation, with ``shared_lora_rank``); xlstm ``mlstm`` (group g's at
``g * (slstm_every - 1) + j``) and ``slstm`` (one a group).  Caches:
dense and moe ``{"blocks": [per-layer {"k", "v"[, "k_scale",
"v_scale"]}]}``; hybrid ``{"mamba": [per layer {"ssm", "conv"}], "attn":
[per invocation {"k", "v"[, scales]}], "tail": [...]}``; xlstm
``{"mlstm": [{"c", "n", "m", "conv"}], "slstm": [{"c", "n", "m",
"h"}]}``.  The KV caches are updated in place; a recurrent state is
replaced by a new dict each step.

Public API: init_lm, forward, lm_loss, init_caches, init_kv_pool, prefill,
prefill_chunk, decode_step, prepare_sparse.  ``forward`` and ``lm_loss``
are the training path: the MLPs run dense, as the reference's, and the
MoE layers' load-balance loss is carried into the loss.  ``init_lm``,
``init_caches`` and ``init_kv_pool`` put their tensors on the card unless
the caller asks for ``device="cpu"``.  A paged KV pool has the caches'
layout with each leaf's (batch, max_len) dims replaced by (n_blocks,
block_size); ``decode_step`` takes it with ``block_table=``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparse_mlp as SM
from repro_torch.device import generator, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.layers import attention as A
from repro_torch.layers import embeddings as E
from repro_torch.layers import mamba2 as M2
from repro_torch.layers import xlstm as XL
from repro_torch.layers.mlp import init_mlp, mlp_apply
from repro_torch.layers.moe import MoEConfig, init_moe, moe_apply
from repro_torch.models import common as C
from repro_torch.sharding import train as ST


# families whose prefill runs in fixed-size chunks against the decode cache
CHUNK_PREFILL_FAMILIES = ("dense", "moe")

# families whose caches are pure per-layer KV and can live in the paged
# block pool
PAGED_KV_FAMILIES = ("dense", "moe")


FAMILIES = ("dense", "moe", "hybrid", "xlstm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: models.lm runs the {FAMILIES} families (vlm and "
            f"encdec: models.vision_lm and models.encdec); got "
            f"{cfg.family!r}")


def moe_cfg(cfg: ModelConfig) -> MoEConfig:
    return MoEConfig(
        d_model=cfg.d_model, d_expert=cfg.d_ff, n_experts=cfg.n_experts,
        top_k=cfg.top_k, n_shared=cfg.n_shared_experts,
        d_shared=cfg.d_ff * max(1, cfg.n_shared_experts),
        capacity_factor=cfg.capacity_factor,
        router_norm_topk=cfg.router_norm_topk,
        activation=(cfg.sparse.activation if cfg.sparse.enabled
                    else cfg.activation))


def mamba_cfg(cfg: ModelConfig) -> M2.Mamba2Config:
    return M2.Mamba2Config(d_model=cfg.d_model, d_state=cfg.ssm_state,
                           head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk)


def xlstm_cfg(cfg: ModelConfig) -> XL.XLSTMConfig:
    return XL.XLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                          slstm_every=cfg.slstm_every or 4)


def _hybrid_layout(cfg: ModelConfig) -> tuple:
    """zamba2: (n_inv, n_main, n_tail): n_inv groups of the shared block
    and ``attn_every`` Mamba2 layers (n_main in all), then n_tail."""
    ae = cfg.attn_every
    if ae < 1:
        raise ValueError(f"{cfg.name}: attn_every={ae} must be >= 1")
    n_main = cfg.n_layers // ae * ae
    return n_main // ae, n_main, cfg.n_layers - n_main


def _xlstm_layout(cfg: ModelConfig) -> tuple:
    """(p, n_groups): blocks a group (one of them sLSTM), groups."""
    p = xlstm_cfg(cfg).slstm_every
    if p < 2 or cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of slstm_every={p} (>= 2)")
    return p, cfg.n_layers // p


def _is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    return cfg.family == "moe" and i >= cfg.first_dense_layers


def has_sparse_mlp(cfg: ModelConfig) -> bool:
    """Whether any layer runs the (sparse) MLP: every dense layer does, a
    moe config only in its ``first_dense_layers``, a hybrid config in its
    shared block, an xlstm config never."""
    if cfg.family == "xlstm":
        return False
    return cfg.family != "moe" or cfg.first_dense_layers > 0


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


def _init_block(gen: torch.Generator, cfg: ModelConfig, device,
                moe_block: bool) -> dict:
    pd = C.param_dtype(cfg)
    blk = {
        "ln1": C.norm_init(cfg, device),
        "attn": A.init_attention(gen, C.attn_cfg(cfg), pd, device),
        "ln2": C.norm_init(cfg, device),
    }
    if moe_block:
        blk["moe"] = init_moe(gen, moe_cfg(cfg), pd, device)
    else:
        blk["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, pd,
                              device)
    if cfg.post_block_norm:
        blk["ln1_post"] = C.norm_init(cfg, device)
        blk["ln2_post"] = C.norm_init(cfg, device)
    return blk


def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda",
            place=None) -> dict:
    """Random weights drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the draws differ from the reference's
    ``jax.random``; tests carry the reference's weights over with
    ``repro_torch.bridge``).  Raises without a GPU unless ``device`` is
    ``"cpu"``.  ``place`` (dense family) maps the embedding and head
    tables and each block as soon as it is drawn, before the next one's
    draws: a mesh rank's ``sharding.sparse.place_serve_params`` keeps its
    part of one layer at a time, so it never holds the whole tree."""
    _check_family(cfg)
    if place is not None and cfg.family != "dense":
        raise ValueError(f"init_lm(place=...): family {cfg.family!r} is not "
                         "placed on a mesh (dense only)")
    if cfg.n_layers % len(_windows(cfg)):
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of local_global_period="
                         f"{cfg.local_global_period}")
    if cfg.family == "hybrid":
        n_inv, n_main, n_tail = _hybrid_layout(cfg)
    elif cfg.family == "xlstm":
        p, n_groups = _xlstm_layout(cfg)
    device = resolve_device(device)
    gen = generator(device, seed)
    pd = C.param_dtype(cfg)
    place = place or (lambda node: node)
    params: dict[str, Any] = {
        "embed": place(E.init_embedding(gen, cfg.vocab_padded, cfg.d_model,
                                        pd, device)),
        "final_norm": C.norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = place(E.init_unembed(gen, cfg.vocab_padded,
                                                 cfg.d_model, pd, device))
    if cfg.family == "hybrid":
        mc = mamba_cfg(cfg)

        def mamba():
            return {"ln": C.norm_init(cfg, device),
                    "mixer": M2.init_mamba2(gen, mc, pd, device)}
        params["mamba"] = [mamba() for _ in range(n_main)]
        if n_tail:
            params["mamba_tail"] = [mamba() for _ in range(n_tail)]
        params["shared"] = _init_block(gen, cfg, device, False)
        r = cfg.shared_lora_rank
        if r:
            hq = cfg.n_heads * cfg.resolved_head_dim
            # lora_b_q starts at 0: a fresh LoRA adds nothing
            params["lora"] = [
                {"lora_a": (torch.randn((cfg.d_model, r), generator=gen,
                                        device=device)
                            * cfg.d_model ** -0.5).to(pd),
                 "lora_b_q": torch.zeros((r, hq), dtype=pd, device=device)}
                for _ in range(n_inv)]
        return params
    if cfg.family == "xlstm":
        xc = xlstm_cfg(cfg)

        def block(init):
            return {"ln": C.norm_init(cfg, device),
                    "cell": init(gen, xc, pd, device)}
        params["mlstm"] = [block(XL.init_mlstm)
                           for _ in range(n_groups * (p - 1))]
        params["slstm"] = [block(XL.init_slstm) for _ in range(n_groups)]
        return params
    params["blocks"] = [place(_init_block(gen, cfg, device,
                                          _is_moe_layer(cfg, i)))
                        for i in range(cfg.n_layers)]
    return params


def _head_table(params: dict) -> torch.Tensor:
    return params.get("unembed", params["embed"])["table"]


def _embed_in(params: dict, cfg: ModelConfig, tokens: torch.Tensor):
    return C.embed(params["embed"], tokens, cfg)


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """The head's float32 logits of final hidden states (..., d)."""
    return C.head_logits(x, _head_table(params), cfg.final_softcap,
                         cfg.vocab_padded)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda") -> dict:
    """Zero decode caches on ``device`` (raises without a GPU unless it is
    ``"cpu"``): one KV dict a layer; hybrid: a Mamba2 state a layer (conv
    tail in ``cfg.dtype``) and a KV dict an invocation of the shared
    block; xlstm: every leaf zero, the stabilizers ``m`` too, as the
    reference's (a prefill starts them at -1e30)."""
    _check_family(cfg)
    device = resolve_device(device)
    kv_dt = C.torch_dtype(cfg.kv_cache_dtype)
    dt = C.compute_dtype(cfg)

    def kv(n):
        return [A.init_kv_cache(batch, max_len, C.attn_cfg(cfg), kv_dt,
                                device) for _ in range(n)]
    if cfg.family == "hybrid":
        n_inv, n_main, n_tail = _hybrid_layout(cfg)
        mc = mamba_cfg(cfg)
        caches = {"mamba": [M2.init_mamba2_state(batch, mc, dt, device)
                            for _ in range(n_main)],
                  "attn": kv(n_inv)}
        if n_tail:
            caches["tail"] = [M2.init_mamba2_state(batch, mc, dt, device)
                              for _ in range(n_tail)]
        return caches
    if cfg.family == "xlstm":
        p, n_groups = _xlstm_layout(cfg)
        xc = xlstm_cfg(cfg)

        def zeroed(state):
            return {k: torch.zeros_like(v) for k, v in state.items()}
        return {"mlstm": [zeroed(XL.init_mlstm_state(batch, xc, dt, device))
                          for _ in range(n_groups * (p - 1))],
                "slstm": [zeroed(XL.init_slstm_state(batch, xc, device))
                          for _ in range(n_groups)]}
    return {"blocks": kv(cfg.n_layers)}


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


def _lora_attn(attn: dict, lora: Optional[dict]) -> dict:
    """The attention weights of one invocation of hybrid's shared block:
    ``wq`` plus the invocation's LoRA delta ``lora_a @ lora_b_q``, computed
    and added in the weights' dtype before any cast to the compute dtype,
    as the reference adds it."""
    if lora is None:
        return attn
    out = dict(attn)
    out["wq"] = attn["wq"] + (lora["lora_a"] @ lora["lora_b_q"]).to(
        attn["wq"].dtype)
    return out


def _block_fwd(blk: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, window: int,
               lora: Optional[dict] = None, aux=0.0):
    """One transformer block over a prompt (dense MLP, or the MoE layer
    routing each sequence as a group); ``lora``: hybrid's per-invocation
    query delta.  Returns (x, kv, aux plus the block's MoE load-balance
    term), ``aux`` being the running sum that training carries."""
    h = C.norm_apply(cfg, blk["ln1"], x)
    h, kv = A.attend(_lora_attn(blk["attn"], lora), h,
                     C.attn_cfg(cfg, window), positions, return_kv=True,
                     kv_chunk=cfg.attn_chunk)
    x = x + _post_norm(cfg, blk, "ln1_post", h)
    h = C.norm_apply(cfg, blk["ln2"], x)
    if "moe" in blk:
        h, a = moe_apply(blk["moe"], h, moe_cfg(cfg))
        aux = aux + a
    else:
        h = mlp_apply(blk["mlp"], h, _mlp_sparse_cfg(cfg),
                      row_shards=C.mlp_shards(cfg))
    x = x + _post_norm(cfg, blk, "ln2_post", h)
    return x, kv, aux


def _placed_block_fwd(blk: dict, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, window: int, aux, i: int):
    """``_block_fwd`` of block ``i``, its leaves gathered first under a
    current training layout (``sharding/train.py:gather``; inside the
    recomputed region, so the backward gathers them again)."""
    return _block_fwd(ST.gather(blk, "blocks", i), x, cfg, positions,
                      window, None, aux)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None):
    """The training forward: tokens (B, S) -> (final hidden states (B, S,
    d) after the final norm, aux).  ``aux`` is the MoE layers' summed
    load-balance loss (a float32 scalar; 0 without MoE layers).  Dense and
    moe run every block, hybrid each group's shared-block invocation with
    its LoRA and then its Mamba2 layers, then the tail (not recomputed, as
    the reference's), xlstm its blocks in the group order; each block is
    recomputed in the backward pass when ``cfg.remat``.  Under a current
    training layout (``sharding/train.py:use_layout``, dense family) each
    node is a rank's part, gathered right before its use."""
    _check_family(cfg)
    dev = tokens.device
    x = C.embed(ST.gather(params["embed"], "embed"), tokens, cfg)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.family == "hybrid":
        n_inv, _, _ = _hybrid_layout(cfg)
        ae = cfg.attn_every
        for g, lora in enumerate(_loras(params, n_inv)):
            x, _, aux = C.remat(cfg, _block_fwd, params["shared"], x, cfg,
                                positions, 0, lora, aux)
            for blk in params["mamba"][g * ae:(g + 1) * ae]:
                x, _ = C.remat(cfg, _mamba_fwd, blk, x, cfg)
        for blk in params.get("mamba_tail") or []:
            x, _ = _mamba_fwd(blk, x, cfg)
    elif cfg.family == "xlstm":
        x, _ = _xlstm_fwd(params, x, cfg)
    else:
        for i, (blk, window) in enumerate(zip(params["blocks"],
                                              _layer_windows(cfg))):
            x, _, aux = C.remat(cfg, _placed_block_fwd, blk, x, cfg,
                                positions, window, aux, i)
    return C.norm_apply(cfg, ST.gather(params["final_norm"], "final_norm"),
                        x), aux


def lm_loss(params: dict, cfg: ModelConfig, batch: dict):
    """batch ``{"tokens", "labels"}`` (B, S) -> (loss, ``{"xent",
    "aux"}``): the chunked cross-entropy (labels of -100 ignored) plus the
    MoE load-balance loss.  On a mesh (a current training layout) the
    batch is the data line's rows and the loss is the global mean
    (``common.chunked_xent``), the same on every rank."""
    hidden, aux = forward(params, cfg, batch["tokens"])
    name = "unembed" if "unembed" in params else "embed"
    table = ST.gather(params[name], name)["table"]
    xent = C.chunked_xent(hidden, batch["labels"], table, cfg.final_softcap,
                          cfg.loss_chunk, cfg.vocab_padded)
    return xent + aux, {"xent": xent, "aux": aux}


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int):
    """Prompt pass building decode caches.  tokens (B, S) -> (next-token
    logits (B, V) float32, caches)."""
    _check_family(cfg)
    dev = tokens.device
    x = _embed_in(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=dev)
    if cfg.family == "hybrid":
        x, caches = _hybrid_fwd(params, x, cfg, positions, max_len)
    elif cfg.family == "xlstm":
        x, caches = _xlstm_fwd(params, x, cfg)
    else:
        blocks = []
        for blk, window in zip(params["blocks"], _layer_windows(cfg)):
            x, kv, _ = _block_fwd(blk, x, cfg, positions, window)
            blocks.append(_seed_cache(kv, max_len, cfg))
        caches = {"blocks": blocks}
    x = C.norm_apply(cfg, params["final_norm"], x)
    return _logits(params, cfg, x[:, -1]), caches


def _seed_cache(kv: tuple, max_len: int, cfg: ModelConfig) -> dict:
    """A decode cache of ``max_len`` holding a prompt's (k, v)."""
    k, v = kv
    cache = A.init_kv_cache(k.shape[0], max_len, C.attn_cfg(cfg),
                            C.torch_dtype(cfg.kv_cache_dtype), k.device)
    return A.update_kv_cache(cache, k, v, 0)


def _mamba_fwd(blk: dict, x: torch.Tensor, cfg: ModelConfig):
    """One Mamba2 layer (pre-norm, residual) over a prompt -> (x, its
    state after the prompt)."""
    h, st = M2.mamba2_forward(blk["mixer"], C.norm_apply(cfg, blk["ln"], x),
                              mamba_cfg(cfg), return_state=True)
    return x + h, st


def _mamba_decode(blk: dict, x: torch.Tensor, cfg: ModelConfig,
                  state: dict):
    h, st = M2.mamba2_decode(blk["mixer"], C.norm_apply(cfg, blk["ln"], x),
                             state, mamba_cfg(cfg))
    return x + h, st


def _loras(params: dict, n_inv: int) -> list:
    return params.get("lora") or [None] * n_inv


def _hybrid_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, max_len: int):
    """zamba2 over a prompt: each group's shared-block invocation (its KV
    seeding a decode cache; the softmax over the prompt alone, as the
    reference's hybrid prefill has no ``kv_pad_to``), then the group's
    Mamba2 layers; then the tail.  Returns (x, caches)."""
    n_inv, _, _ = _hybrid_layout(cfg)
    ae = cfg.attn_every
    caches: dict = {"mamba": [], "attn": []}
    for g, lora in enumerate(_loras(params, n_inv)):
        x, kv, _ = _block_fwd(params["shared"], x, cfg, positions, 0, lora)
        caches["attn"].append(_seed_cache(kv, max_len, cfg))
        for blk in params["mamba"][g * ae:(g + 1) * ae]:
            x, st = _mamba_fwd(blk, x, cfg)
            caches["mamba"].append(st)
    if params.get("mamba_tail"):
        caches["tail"] = []
        for blk in params["mamba_tail"]:
            x, st = _mamba_fwd(blk, x, cfg)
            caches["tail"].append(st)
    return x, caches


def _hybrid_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                   caches: dict, cache_len, alphas=None,
                   collect_stats: bool = False):
    """One zamba2 decode step.  Invocation g of the shared block takes row
    g of the n_layers-long ``alphas`` ((n_layers,) or (n_layers, B)), as
    the reference slices ``alphas[:n_inv]``; stats (n_inv, B)."""
    n_inv, _, _ = _hybrid_layout(cfg)
    ae = cfg.attn_every
    alphas = _layer_alphas(cfg, alphas, x.device)
    new: dict = {"mamba": [], "attn": []}
    stats = []
    for g, lora in enumerate(_loras(params, n_inv)):
        x, cache, st = _block_decode(params["shared"], x, cfg,
                                     caches["attn"][g], cache_len, 0,
                                     alphas[g], collect_stats=collect_stats,
                                     lora=lora)
        new["attn"].append(cache)
        stats.append(st)
        for i in range(g * ae, (g + 1) * ae):
            x, state = _mamba_decode(params["mamba"][i], x, cfg,
                                     caches["mamba"][i])
            new["mamba"].append(state)
    if params.get("mamba_tail"):
        new["tail"] = []
        for blk, state in zip(params["mamba_tail"], caches["tail"]):
            x, state = _mamba_decode(blk, x, cfg, state)
            new["tail"].append(state)
    return x, new, _stack_stats(stats) if collect_stats else None


def _xlstm_blocks(cfg: ModelConfig):
    """The blocks in layer order, the reference's per group: (kind, index
    in its list), kind "m" or "s": m0, s, m1, ..., m(p-2)."""
    p, n_groups = _xlstm_layout(cfg)
    for g in range(n_groups):
        yield "m", g * (p - 1)
        yield "s", g
        for j in range(1, p - 1):
            yield "m", g * (p - 1) + j


def _xlstm_block(fwd, blk: dict, x: torch.Tensor, cfg: ModelConfig):
    h, st = fwd(blk["cell"], C.norm_apply(cfg, blk["ln"], x),
                xlstm_cfg(cfg), return_state=True)
    return x + h, st


def _xlstm_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """xlstm over a prompt, each cell from a fresh state (in training each
    block recomputed in the backward pass when ``cfg.remat``).  Returns
    (x, caches)."""
    caches: dict = {"mlstm": [], "slstm": []}
    for kind, i in _xlstm_blocks(cfg):
        part = "mlstm" if kind == "m" else "slstm"
        fwd = XL.mlstm_forward if kind == "m" else XL.slstm_forward
        x, st = C.remat(cfg, _xlstm_block, fwd, params[part][i], x, cfg)
        caches[part].append(st)
    return x, caches


def _xlstm_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  caches: dict):
    xc = xlstm_cfg(cfg)
    new: dict = {"mlstm": [None] * len(caches["mlstm"]),
                 "slstm": [None] * len(caches["slstm"])}
    for kind, i in _xlstm_blocks(cfg):
        part = "mlstm" if kind == "m" else "slstm"
        blk = params[part][i]
        dec = XL.mlstm_decode if kind == "m" else XL.slstm_decode
        h, new[part][i] = dec(blk["cell"], C.norm_apply(cfg, blk["ln"], x),
                              caches[part][i], xc)
        x = x + h
    return x, new


def _moe_block(blk: dict, h: torch.Tensor, cfg: ModelConfig,
               collect_stats: bool):
    """The MoE layer in place of the MLP over (B, S, d) ``h``.  Its stats
    are zeros (B,), with the per-shard riders under ``tp_shards``, so they
    stack against the MLP layers'."""
    out, _ = moe_apply(blk["moe"], h, moe_cfg(cfg))
    stats = (SM.zero_mlp_stats((h.shape[0],), h.device,
                               cfg.sparse.tp_shards)
             if collect_stats else None)
    return out, stats


def _block_decode(blk: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                  cache_len, window: int, alpha, collect_stats: bool = False,
                  block_table=None, lora: Optional[dict] = None):
    """One block, single-token decode.  Returns (x, cache, stats or None).
    ``block_table`` switches the attention onto the paged KV pool
    (``cache`` is then this layer's pool leaves); ``lora``: hybrid's
    per-invocation query delta."""
    h = C.norm_apply(cfg, blk["ln1"], x)
    acfg = C.attn_cfg(cfg, window)
    attn = _lora_attn(blk["attn"], lora)
    if block_table is not None:
        h, cache = A.paged_decode_attend(attn, h, acfg, cache, cache_len,
                                         block_table)
    else:
        h, cache = A.decode_attend(attn, h, acfg, cache, cache_len)
    x = x + _post_norm(cfg, blk, "ln1_post", h)
    h = C.norm_apply(cfg, blk["ln2"], x)
    if "moe" in blk:                      # each slot a group of one token
        out, stats = _moe_block(blk, h, cfg, collect_stats)
        return x + _post_norm(cfg, blk, "ln2_post", out), cache, stats
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
    alphas = _layer_alphas(cfg, alphas, x.device)
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


def _layer_alphas(cfg: ModelConfig, alphas, device) -> torch.Tensor:
    """The decode step's alphas as a float32 tensor: the static schedule,
    or the caller's (n_layers,) or (n_layers, B)."""
    alphas = torch.as_tensor(_alphas(cfg) if alphas is None else alphas,
                             dtype=torch.float32, device=device)
    if alphas.shape[0] != cfg.n_layers:
        raise ValueError(f"alphas {tuple(alphas.shape)}: need n_layers="
                         f"{cfg.n_layers} rows")
    return alphas


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
    ``MLP_STAT_KEYS`` of (L, B) float32 tensors (hybrid: L = n_inv, the
    shared block's invocations; xlstm: no stats, None), and with
    ``tp_shards`` also the per-shard riders (L, B, tp_shards).
    ``block_table`` (B, nbps) int32: ``caches`` is a paged KV pool
    (``init_kv_pool``) and ``cache_len`` must be per slot."""
    _check_family(cfg)
    if block_table is not None and cfg.family not in PAGED_KV_FAMILIES:
        raise NotImplementedError(
            f"paged KV decode supports {PAGED_KV_FAMILIES}, not "
            f"{cfg.family!r}")
    x = _embed_in(params, cfg, token)
    if cfg.family == "hybrid":
        x, caches, stats = _hybrid_decode(params, x, cfg, caches, cache_len,
                                          alphas, collect_stats)
    elif cfg.family == "xlstm":
        x, caches = _xlstm_decode(params, x, cfg, caches)
        stats = None
    else:
        x, caches, stats = _dense_stack_decode(
            params, x, cfg, caches, cache_len, alphas, collect_stats,
            block_table)
    x = C.norm_apply(cfg, params["final_norm"], x)
    logits = _logits(params, cfg, x[:, 0])
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
                              offset, valid, kv_chunk=cfg.attn_chunk)
    x = x + _post_norm(cfg, blk, "ln1_post", h)
    h = C.norm_apply(cfg, blk["ln2"], x)
    if "moe" in blk:         # each sequence's chunk a group, pad rows too
        out, stats = _moe_block(blk, h, cfg, collect_stats)
        return x + _post_norm(cfg, blk, "ln2_post", out), cache, stats
    out, stats = _chunk_mlp(blk["mlp"], h, cfg, alpha, tok_mask,
                            collect_stats)
    return x + _post_norm(cfg, blk, "ln2_post", out), cache, stats


def _chunk_mlp(mlp: dict, h: torch.Tensor, cfg: ModelConfig, alpha,
               tok_mask, collect_stats: bool):
    """The MLP over a prefill chunk's (B, S, d) ``h``: real rows at the
    layer's ``alpha`` (scalar or per slot (B,)), pad rows at
    ``DEAD_SLOT_ALPHA``.  Returns (out, stats averaged over the real rows,
    or None)."""
    al = torch.as_tensor(alpha, dtype=torch.float32, device=h.device)
    if al.ndim == 1:                                       # per slot (B,)
        al = al[:, None]
    a_tok = torch.where(tok_mask, al, torch.tensor(
        SM.DEAD_SLOT_ALPHA, device=h.device)).reshape(-1)
    out = mlp_apply(mlp, h, _mlp_sparse_cfg(cfg), prefill=True,
                    alpha=a_tok, return_stats=collect_stats)
    if not collect_stats:
        return out, None
    out, st = out
    return out, {k: _chunk_stat_mean(v, tok_mask) for k, v in st.items()}


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
    logits = _logits(params, cfg, x[torch.arange(b, device=dev), last])
    if collect_stats:
        return logits, caches, stats
    return logits, caches


def _prepare_node(node: dict, sparse) -> dict:
    """The reference's walk over one gated node: an MLP node gets its
    gate-weight sign pack (int8 weights: quantized, ``core/quantize.py``);
    an MoE node (it has a ``router``) keeps its float expert stacks and
    gets their sign pack (E, f, d/32), and its shared expert is an MLP
    node.  A node already quantized passes through."""
    if "router" in node:
        out = dict(node)
        if "shared" in node:
            out["shared"] = _prepare_node(node["shared"], sparse)
        out["sign_wg"] = kops.sign_pack(node["wg_t"])
        return out
    if "wg_t" not in node:
        return node
    return SM.prepare_sparse_params(node, sparse)


def prepare_sparse(params: dict, sparse: Optional[SM.SparseInferConfig] = None
                   ) -> dict:
    """Offline step for serving: pack the gate-weight sign bits of every
    gated node (each MLP, each MoE layer's expert stacks and its shared
    expert); with ``sparse.weight_dtype == "int8"`` also quantize every
    MLP node, the shared experts included, while the expert stacks stay
    float.  Like the reference's walk it reaches every block list of the
    tree (``blocks``; hybrid's one ``shared`` block, packed once; an
    encoder-decoder's ``enc_blocks`` and ``dec_blocks``; a vlm's
    ``self_blocks`` and ``cross_blocks``).  xlstm has no gated node."""
    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return node
        if "wg_t" in node or "wg_q" in node:      # an MLP or an MoE node
            return _prepare_node(node, sparse)
        return {k: walk(v) for k, v in node.items()}
    return walk(params)
