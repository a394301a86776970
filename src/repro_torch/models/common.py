"""Shared model machinery: counterpart of ``repro/models/common.py``."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.layers import embeddings as E
from repro_torch.layers.attention import AttentionConfig
from repro_torch.layers.norms import (init_layernorm, init_rmsnorm,
                                      layernorm, rmsnorm)
from repro_torch.layers.scan_utils import counted_as_forward
from repro_torch.sharding import rules as R


def norm_init(cfg: ModelConfig, device="cpu") -> dict:
    if cfg.norm == "layernorm":
        return init_layernorm(cfg.d_model, device=device)
    return init_rmsnorm(cfg.d_model, device=device)


def norm_apply(cfg: ModelConfig, params: dict, x: torch.Tensor):
    if cfg.norm == "layernorm":
        return layernorm(params, x)
    return rmsnorm(params, x)


def attn_cfg(cfg: ModelConfig, window: int = 0, cross: bool = False,
             d_kv_input: int = 0) -> AttentionConfig:
    """The attention of a block; ``window`` is the layer's own (gemma2's
    local layers), not ``cfg.window``; ``cross`` takes K/V from encoder
    states or image embeddings of width ``d_kv_input`` (0: d_model).
    Under a current mesh a self-attention holds this rank's heads
    (``rules.attention_heads``): its projections, caches and kernels run
    on them, and ``head_shards`` tells the out projection to sum the
    line's partials."""
    h, kvh, shards = cfg.n_heads, cfg.n_kv_heads, 1
    if not cross and R.current_mesh() is not None:
        split = R.attention_heads(h, kvh)
        h, kvh, shards = (split.q1 - split.q0, split.k1 - split.k0,
                          split.shards)
    return AttentionConfig(
        d_model=cfg.d_model, n_heads=h, n_kv_heads=kvh,
        head_dim=cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm, softcap=cfg.attn_softcap,
        rope_theta=cfg.rope_theta, window=window, cross=cross,
        d_kv_input=d_kv_input, paged_kernel=cfg.paged_attn_kernel,
        head_shards=shards)


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ("float32", "bfloat16", "int8", ...) -> dtype."""
    return getattr(torch, name)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def stacked_init(init_fn, generator: torch.Generator, n: int) -> dict:
    """``n`` draws of ``init_fn(generator)`` stacked along a leading axis:
    the reference's layer-stacked pytree (its ``vmap`` over split keys), one
    draw after another from the one generator."""
    return _stack([init_fn(generator) for _ in range(n)])


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def take_layer(stacked, i: int):
    """Layer ``i`` of a stacked tree (leading-axis index on every leaf)."""
    if isinstance(stacked, dict):
        return {k: take_layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def head_logits(hidden: torch.Tensor, table: torch.Tensor,
                softcap: float = 0.0, vocab: int = 0) -> torch.Tensor:
    """Full float32 logits for decode steps: (..., d) -> (..., V), with
    gemma2's final ``tanh(logits / softcap) * softcap``.  A ``table`` of
    fewer rows than ``vocab`` is this rank's vocabulary share under the
    current mesh: its logits (softcapped) are gathered over the 'model'
    line into the full vocabulary, the same on every rank."""
    logits = hidden.float() @ table.float().T
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    if vocab > table.shape[0]:
        logits = R.model_concat(logits)
    return logits


def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """The token embeddings in the compute dtype, with gemma's scale.  A
    table of fewer rows than ``cfg.vocab_padded`` is this rank's
    vocabulary share under the current mesh: it gives its rows of the
    tokens in its range and zeros elsewhere, and the line's parts are
    summed in rank order (one part is non-zero, so the sum is the row)."""
    table = params["table"]
    rows = None
    if cfg.vocab_padded > table.shape[0]:
        v_l = table.shape[0]
        local = tokens.long() - R.current_mesh().axis_index("model") * v_l
        mine = (local >= 0) & (local < v_l)
        rows = torch.where(mine[..., None], table[local.clamp(0, v_l - 1)],
                           torch.zeros((), dtype=table.dtype,
                                       device=table.device))
        rows = R.model_sum(rows)
    return E.embed(params, tokens, cfg.embed_scale, compute_dtype(cfg),
                   rows=rows)


def chunked_xent(hidden: torch.Tensor, labels: torch.Tensor,
                 table: torch.Tensor, softcap: float = 0.0,
                 chunk: int = 2048, vocab: int = 0) -> torch.Tensor:
    """Mean token cross-entropy without the whole (B, S, vocab) logits.

    hidden (B, S, d); labels (B, S) integer, -100 (any negative) ignored;
    table (V, d).  The sequence axis is cut in chunks of the largest
    divisor of S not above ``chunk``; each chunk's logits are float32,
    with the softcap; the loss is the sum over valid labels divided by
    ``max(count, 1)``.

    Under a current mesh a ``table`` of fewer rows than ``vocab`` is this
    rank's vocabulary share: the chunk's logits are joined over the
    'model' line (``rules.model_concat``) and the hidden states enter it
    through ``rules.model_entry``.  On a mesh of several data lines the
    rows are the line's: the count is the global one (every line's, in
    line order) and the lines' sums over it are summed in line order, the
    global mean on every rank."""
    b, s, _ = hidden.shape
    chunk = max(1, min(chunk, s))
    while s % chunk:
        chunk -= 1
    split = vocab > table.shape[0]
    if split:
        hidden = R.model_entry(hidden)
    tab = table.float()
    losses, counts = [], []
    for c0 in range(0, s, chunk):
        logits = torch.einsum("bcd,vd->bcv",
                              hidden[:, c0:c0 + chunk].float(), tab)
        if softcap > 0.0:
            logits = torch.tanh(logits / softcap) * softcap
        if split:
            logits = R.model_concat(logits)
        yb = labels[:, c0:c0 + chunk].long()
        lse = torch.logsumexp(logits, dim=-1)                    # (B, c)
        picked = torch.gather(logits, -1,
                              torch.clamp(yb, min=0)[..., None])[..., 0]
        valid = yb >= 0
        losses.append(torch.where(valid, lse - picked, 0.0).sum())
        counts.append(valid.sum())
    count = torch.stack(counts).sum()
    lines = R.data_lines()
    if lines > 1:
        count = R.gather_line(count, R.data_axis()).sum()
    loss = torch.stack(losses).sum() / torch.clamp(count, min=1)
    return R.line_sum(loss, R.data_axis()) if lines > 1 else loss


def mlp_shards(cfg: ModelConfig) -> int:
    """How many ways the dense MLP's rows split over the current mesh's
    'model' line: its size where it divides ``d_ff`` (the rules' split of
    the MLP leaves), else 1."""
    m = R.model_size()
    return m if m > 1 and cfg.d_ff % m == 0 else 1


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward pass (its activations not
    kept) when ``cfg.remat`` and autograd is recording: the reference's
    ``jax.checkpoint`` around a block.  The forward values are the plain
    call's."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(counted_as_forward(fn), *args,
                          use_reentrant=False)
    return fn(*args)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab; torch.argmax returns the first maximal index,
    as jnp.argmax does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(generator: torch.Generator, logits: torch.Tensor,
                       temperature: float = 1.0) -> torch.Tensor:
    """A draw from softmax(logits / temperature) over the last axis, from
    ``generator`` (the reference's ``jax.random.categorical`` under a key;
    the draws differ, the distribution is the same); temperature <= 0 is
    greedy."""
    if temperature <= 0.0:
        return greedy_sample(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(flat, 1, generator=generator)
    return out.reshape(probs.shape[:-1]).to(torch.int32)
