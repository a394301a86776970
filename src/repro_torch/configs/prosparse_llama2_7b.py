"""ProSparse-Llama2-7B: the paper's own evaluation model (ReLU-fied llama2,
arXiv:2402.13516), at its published shape."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register, default_sparse


@register("prosparse-llama2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="prosparse-llama2-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
        d_ff=11008, vocab=32000,
        tie_embeddings=False, activation="relu",   # ReLU-fied
        sparse=default_sparse(),
        kv_cache_dtype="int8",       # MHA KV at 32k x128 exceeds HBM in bf16
        loss_chunk=4096,
    )
