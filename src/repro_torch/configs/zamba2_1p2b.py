"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block w/ LoRA
(arXiv:2411.15242). 38 Mamba2 layers, shared transformer block every 6."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register, default_sparse


@register("zamba2-1.2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab=32000,
        ssm_state=64, ssm_head_dim=64, attn_every=6, shared_lora_rank=64,
        rope_theta=10000.0, tie_embeddings=True, activation="silu",
        sparse=default_sparse(),     # applies to the shared block's gated MLP
        ssm_chunk=64,                # the (B, H, K, K) segment-sum tile
        microbatches=2,
        loss_chunk=4096,
    )
