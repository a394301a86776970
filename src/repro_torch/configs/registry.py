"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus the reduced
(CPU smoke) variant — the counterpart of ``repro/configs/registry.py``.

Registered: every arch of the reference: the dense family
(prosparse-llama2-7b and -13b, qwen3-8b, qwen1.5-32b, granite-34b,
gemma2-2b), the moe family (deepseek-moe-16b, olmoe-1b-7b), encdec
(seamless-m4t-medium), vlm (llama-3.2-vision-90b), hybrid (zamba2-1.2b)
and xlstm (xlstm-125m)."""
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
    """Tiny same-family config for CPU smoke tests: the reference's cut for
    each family (dense: two of its layer pattern; moe: the dense first
    layers plus 3 MoE layers of 8 experts, top-k at most 2; hybrid: two
    groups of the shared block and 2 Mamba2 layers plus a tail layer, SSM
    state and head 16, d_ff 128, LoRA rank 8; xlstm: one group of 4 blocks;
    vlm: two groups of a self and a cross layer, 8 image tokens; encdec: 2
    encoder and 2 decoder layers, 16 frames)."""
    cfg = get_config(name)
    kw: dict = dict(
        d_model=64, d_ff=0 if cfg.d_ff == 0 else 128, vocab=512,
        n_heads=4, head_dim=16, max_seq=32, dtype="float32",
        param_dtype="float32", kv_cache_dtype="float32", attn_chunk=8,
        loss_chunk=128, remat=False, ssm_chunk=4, microbatches=1,
    )
    kw["n_kv_heads"] = (1 if cfg.n_kv_heads == 1
                        else 4 if cfg.n_kv_heads == cfg.n_heads else 2)
    if cfg.window:
        kw["window"] = 8
    if cfg.family == "dense":
        kw["n_layers"] = 2 * (cfg.local_global_period or 1)
    elif cfg.family == "moe":
        kw["n_layers"] = cfg.first_dense_layers + 3
        kw["n_experts"] = 8
        kw["top_k"] = min(cfg.top_k, 2)
        kw["d_ff"] = 32
        kw["capacity_factor"] = 4.0
    elif cfg.family == "hybrid":
        kw["attn_every"] = 2
        kw["n_layers"] = 5            # 2 groups + 1 tail layer
        kw["ssm_state"] = 16
        kw["ssm_head_dim"] = 16
        kw["d_ff"] = 128
        if cfg.shared_lora_rank:
            kw["shared_lora_rank"] = 8
    elif cfg.family == "xlstm":
        kw["n_layers"] = 4
    elif cfg.family == "vlm":
        kw["cross_every"] = 2
        kw["n_layers"] = 4
        kw["n_image_tokens"] = 8
    elif cfg.family == "encdec":
        kw["n_layers"] = 2
        kw["n_enc_layers"] = 2
        kw["n_frames"] = 16
    else:
        raise ValueError(f"no reduced config for family {cfg.family!r}")
    if cfg.sparse.enabled:
        kw["sparse"] = dataclasses.replace(cfg.sparse, capacity_frac=0.5)
    return cfg.replace(name=cfg.name + "-reduced", **kw)


# arch modules register themselves on import (bottom: decorator exists)
from repro_torch.configs import (  # noqa: E402,F401
    gemma2_2b, granite_34b, qwen3_8b, qwen1_5_32b, deepseek_moe_16b,
    olmoe_1b_7b, llama32_vision_90b, prosparse_llama2_7b,
    prosparse_llama2_13b, seamless_m4t_medium, xlstm_125m, zamba2_1p2b,
)
