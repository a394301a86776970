"""qwen3-8b [dense]: GQA kv=8 with per-head q/k RMSNorm
(hf:Qwen/Qwen3-8B)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register, default_sparse


@register("qwen3-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=12288, vocab=151936,
        qk_norm=True, rope_theta=1e6, tie_embeddings=False,
        activation="silu",
        sparse=default_sparse(),
        loss_chunk=1024,
    )
