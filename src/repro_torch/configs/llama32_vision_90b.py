"""llama-3.2-vision-90b [vlm]: a decoder backbone with a gated
cross-attention image layer every 5th layer
(hf:meta-llama/Llama-3.2-90B-Vision).  The vision frontend is a stub:
inputs are precomputed patch embeddings."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register, default_sparse


@register("llama-3.2-vision-90b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=28672, vocab=128256,
        cross_every=5, n_image_tokens=1600,
        rope_theta=5e5, tie_embeddings=True, activation="silu",
        sparse=default_sparse(),
        weight_gather_serve=True,
        loss_chunk=512,
    )
