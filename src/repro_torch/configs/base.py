"""Model configuration: the counterpart of ``repro/configs/base.py``.

Field names, types and defaults are the reference's own, so a port config
compares field for field with its JAX twin.  Ported: ``ModelConfig``, the
SLA tiers, ``ControllerConfig``, ``PagedKVConfig`` and ``MetricsConfig``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.sparse_mlp import SparseInferConfig


@dataclasses.dataclass(frozen=True)
class SLATier:
    """One per-request service tier: a per-slot alpha offset added to the
    per-layer schedule and, under a per-tier controller, its own density
    target (``target``: the controller's ``target_density`` times
    ``target_scale``).  ``priority`` ranks tiers for preemption: victims
    come from the lowest priority first."""

    name: str
    alpha_offset: float = 0.0
    target_scale: float = 1.0
    priority: int = 1

    def target(self, base_density: float) -> float:
        return float(min(1.0, max(1e-3, base_density * self.target_scale)))


# offsets sized for the reduced configs, as in the reference
DEFAULT_SLA_TIERS: tuple = (
    SLATier("latency", alpha_offset=-0.25, target_scale=0.6, priority=0),
    SLATier("balanced", priority=1),
    SLATier("quality", alpha_offset=0.25, target_scale=1.4, priority=2),
)


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """The online adaptive-alpha controller of the serve path
    (``runtime/controller.py``): between decode steps each layer's alpha
    moves so that realized density tracks ``target_density``, and periodic
    masked-strategy audit steps bound the false-negative rate."""

    enabled: bool = False
    target_density: float = 0.25   # per-layer realized density setpoint
    gain: float = 0.5              # integral gain on (density - target)
    ema: float = 0.4               # EMA weight of a new observation
    alpha_min: float = 0.25        # clamp floor (most aggressive skipping)
    alpha_max: float = 8.0         # clamp ceiling (most conservative)
    max_step: float = 0.25         # per-update |dalpha| bound
    audit_period: int = 8          # masked-path audit every N decode steps
    fn_budget: float = 0.02        # tolerated active-but-skipped rate
    fn_gain: float = 4.0           # conservatism push per unit FN excess
    adapt_capacity: bool = False   # re-size capacity from the observed
                                   # demand at refill boundaries (no-op
                                   # under a capacity-bucket ladder)
    per_tier: bool = False         # one (alpha vector, density target) per
                                   # ServeConfig.sla_tiers entry: (T, L)
    # the sharded serve's per-shard bucket ladder: each model shard picks
    # its own rung when len(ladder) ** tp_shards <= bucket_tuple_cap, from
    # its union demand times shard_slack
    per_shard_buckets: bool = True
    bucket_tuple_cap: int = 16
    shard_slack: float = 1.3
    # weight of the sparse-prefill density error in the alpha update,
    # relative to the decode one (0 = prefill chunks are observed only)
    prefill_weight: float = 0.25


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
class MetricsConfig:
    """The serve path's observability (``runtime/metrics.py:MetricsHub``):
    counters, gauges, histograms, phase spans and the JSONL, trace and
    exposition sinks.  Disabled (the default) every emit method returns at
    once and the serve path is bitwise the metrics-free one."""

    enabled: bool = False
    jsonl_path: str = ""        # JSONL event-stream sink ("" = in-memory
                                # ring only; MetricsHub.events())
    trace: bool = False         # record Chrome/Perfetto trace events even
                                # with no trace_path
    trace_path: str = ""        # write trace_event JSON here on flush()
    snapshot_path: str = ""     # write the Prometheus-style exposition on
                                # flush()
    cadence: int = 8            # publish the gauge families (controller,
                                # pool) every N decode steps
    hist_max_exact: int = 2048  # histogram observations kept exact; past
                                # the cap they fold into the bucket ladder
                                # (0 = exact forever, as throughput_report)
    hist_buckets: tuple = ()    # bucket upper bounds in seconds; () =
                                # metrics.DEFAULT_BUCKETS
    watchdog: bool = True       # warn and count any first use (a kernel
                                # library load, a new capacity bucket)
                                # after the first serve drain
    events_keep: int = 4096     # in-memory ring sizes (events and trace)


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
