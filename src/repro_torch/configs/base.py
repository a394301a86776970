"""Model configuration: the counterpart of ``repro/configs/base.py``.

Field names, types and defaults are the reference's own, so a port config
compares field for field with its JAX twin.  Only the configs this slice
serves are ported (``ModelConfig``, the SLA tiers and ``PagedKVConfig``);
the controller and metrics configs come with their slices.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.sparse_mlp import SparseInferConfig


@dataclasses.dataclass(frozen=True)
class SLATier:
    """One per-request service tier: a per-slot alpha offset added to the
    per-layer schedule (``target_scale`` and ``priority`` serve the
    controller and preemption, not ported yet)."""

    name: str
    alpha_offset: float = 0.0
    target_scale: float = 1.0
    priority: int = 1


# offsets sized for the reduced configs, as in the reference
DEFAULT_SLA_TIERS: tuple = (
    SLATier("latency", alpha_offset=-0.25, target_scale=0.6, priority=0),
    SLATier("balanced", priority=1),
    SLATier("quality", alpha_offset=0.25, target_scale=1.4, priority=2),
)


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    """Paged KV pool for the slot-refill serve path: a global block pool
    plus per-slot block tables in place of per-slot ``max_len`` buffers.
    Committed full prompt blocks are shared through a hash trie (repeated
    system prompts and resumed session history admit by reference), and
    diverging reuse is copy-on-write forked."""

    block_size: int = 16    # tokens per pool block; must divide
                            # ServeConfig.max_len, and prefill_chunk must
                            # be a multiple of it when chunked prefill is on
    pool_blocks: int = 0    # total blocks INCLUDING the two reserved ones
                            # (null + trash); 0 = auto-size to the dense
                            # equivalent batch * max_len/block_size + 2
    prefix_cache: bool = True   # hash-trie admission of committed blocks
    max_sessions: int = 64  # LRU cap on retained session chains


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | xlstm | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # attention flavor
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    window: int = 0
    local_global_period: int = 0
    rope_theta: float = 10000.0
    embed_scale: bool = False
    tie_embeddings: bool = True
    activation: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"
    post_block_norm: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_norm_topk: bool = True

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0
    shared_lora_rank: int = 0
    slstm_every: int = 0

    # VLM
    cross_every: int = 0
    n_image_tokens: int = 0

    # enc-dec (audio)
    n_enc_layers: int = 0
    n_frames: int = 0

    # SparseInfer (the paper's technique)
    sparse: SparseInferConfig = dataclasses.field(
        default_factory=SparseInferConfig)

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"   # "int8": quantized KV (scales factored)
    paged_attn_kernel: bool = False

    # execution
    max_seq: int = 4096
    remat: bool = True
    microbatches: int = 1
    loss_chunk: int = 2048
    attn_chunk: int = 1024
    sp_activations: bool = True
    pure_fsdp_train: bool = False
    seq_shard_kv: bool = False
    weight_gather_serve: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 256) * 256

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
