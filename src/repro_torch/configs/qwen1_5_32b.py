"""qwen1.5-32b [dense]: MHA (kv=40) with QKV bias
(hf:Qwen/Qwen1.5 family)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register, default_sparse


@register("qwen1.5-32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
        d_ff=27392, vocab=152064,
        qkv_bias=True, rope_theta=1e6, tie_embeddings=False,
        activation="silu",
        sparse=default_sparse(),
        kv_cache_dtype="int8",       # MHA kv=40 @32k x128: bf16 cache exceeds HBM
        loss_chunk=1024,
    )
