"""Shared model machinery: counterpart of ``repro/models/common.py``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.attention import AttentionConfig
from repro_torch.layers.norms import init_rmsnorm, rmsnorm


def norm_init(cfg: ModelConfig, device="cpu") -> dict:
    return init_rmsnorm(cfg.d_model, device=device)


def norm_apply(cfg: ModelConfig, params: dict, x: torch.Tensor):
    return rmsnorm(params, x)


def attn_cfg(cfg: ModelConfig) -> AttentionConfig:
    return AttentionConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        paged_kernel=cfg.paged_attn_kernel)


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ("float32", "bfloat16", "int8", ...) -> dtype."""
    return getattr(torch, name)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def head_logits(hidden: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Full float32 logits for decode steps: (..., d) -> (..., V)."""
    return hidden.float() @ table.float().T


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab; torch.argmax returns the first maximal index,
    as jnp.argmax does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
