"""Model configuration: the counterpart of ``repro/configs/base.py``.

Field names, types and defaults are the reference's own, so a port config
compares field for field with its JAX twin.  Ported: ``ModelConfig`` (with
``d_expert``, ``is_decoder_only``, ``supports_long_context``,
``param_count`` and ``active_param_count``), the SLA tiers,
``ControllerConfig``, ``PagedKVConfig``, ``MetricsConfig`` and the shape
matrix (``ShapeConfig``, ``SHAPES``, ``shape_applicable``).
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

    @property
    def is_decoder_only(self) -> bool:
        return self.family in ("dense", "moe", "hybrid", "xlstm")

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode (SSM/hybrid state): runs long_500k."""
        return self.family in ("hybrid", "xlstm")

    @property
    def d_expert(self) -> int:
        return self.d_ff  # for MoE configs d_ff is the per-expert width

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), the
        reference's formula."""
        d, v = self.d_model, self.vocab
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.family == "moe":
            ffn = 3 * d * self.d_ff * self.n_experts
            ffn += 3 * d * self.d_ff * self.n_shared_experts \
                + d * self.n_experts
        elif self.family == "xlstm":
            di = 2 * d
            ffn = d * 2 * di + 3 * di * di + di * d
            attn = 0
        elif self.family == "hybrid":
            di = 2 * d
            ffn = d * (2 * di + 2 * self.ssm_state
                       + di // self.ssm_head_dim) + di * d
            ffn += (attn + 3 * d * self.d_ff) / max(1, self.attn_every)
            attn = 0
        else:
            ffn = (3 if self.gated_mlp else 2) * d * self.d_ff
        layers = self.n_layers + self.n_enc_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        return int(layers * (attn + ffn) + emb)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        ffn = 3 * d * self.d_ff * (self.top_k + self.n_shared_experts)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(self.n_layers * (attn + ffn) + emb)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the reference's shape matrix."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig
                     ) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs, with the reference's skip
    reason if not."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention KV decode at 500k is quadratic-cost "
                       "prefill / O(L) per-token reads; assignment restricts "
                       "long_500k to SSM/hybrid archs")
    return True, ""
