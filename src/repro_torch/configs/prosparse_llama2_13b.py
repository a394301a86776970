"""ProSparse-Llama2-13B: the paper's primary evaluation model (ReLU-fied
llama2, arXiv:2402.13516). d=5120, k=13824 -> Table I op counts."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register, default_sparse


@register("prosparse-llama2-13b")
def config() -> ModelConfig:
    return ModelConfig(
        name="prosparse-llama2-13b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
        d_ff=13824, vocab=32000,
        tie_embeddings=False, activation="relu",
        sparse=default_sparse(),
        kv_cache_dtype="int8",       # MHA KV at 32k x128 exceeds HBM in bf16
        loss_chunk=4096,
    )
