"""olmoe-1b-7b [moe]: 64 experts top-8, no shared experts, qk-norm
(arXiv:2409.02060)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register, default_sparse


@register("olmoe-1b-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1024, vocab=50304,
        n_experts=64, top_k=8, n_shared_experts=0,
        capacity_factor=1.25, router_norm_topk=False, qk_norm=True,
        tie_embeddings=True, activation="silu",
        sparse=default_sparse(),
        pure_fsdp_train=True,
        loss_chunk=2048,
    )
