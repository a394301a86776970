"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus the reduced
(CPU smoke) variant — the counterpart of ``repro/configs/registry.py``.

Only ``prosparse-llama2-7b`` is registered; other archs come with their
slices of the port."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_mlp import SparseInferConfig


def default_sparse(activation: str = "relu", enabled: bool = True,
                   **kw) -> SparseInferConfig:
    """The paper's technique, on by default for decode (ReLU-fied gate)."""
    return SparseInferConfig(
        enabled=enabled, strategy="gather", activation=activation,
        alpha_base=1.0, alpha_early=1.03, alpha_early_frac=0.5,
        capacity_frac=0.20, group_size=8, use_actual_sparsity=True, **kw)


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def arch_names() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {arch_names()}")
    return _REGISTRY[name]()


def reduced_config(name: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (dense family only)."""
    cfg = get_config(name)
    kw: dict = dict(
        d_model=64, d_ff=0 if cfg.d_ff == 0 else 128, vocab=512,
        n_heads=4, head_dim=16, max_seq=32, dtype="float32",
        param_dtype="float32", kv_cache_dtype="float32", attn_chunk=8,
        loss_chunk=128, remat=False, ssm_chunk=4, microbatches=1,
    )
    kw["n_kv_heads"] = (1 if cfg.n_kv_heads == 1
                        else 4 if cfg.n_kv_heads == cfg.n_heads else 2)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue A)")
    kw["n_layers"] = 2 * (cfg.local_global_period or 1)
    if cfg.sparse.enabled:
        kw["sparse"] = dataclasses.replace(cfg.sparse, capacity_frac=0.5)
    return cfg.replace(name=cfg.name + "-reduced", **kw)


# arch modules register themselves on import (bottom: decorator exists)
from repro_torch.configs import prosparse_llama2_7b  # noqa: E402,F401
