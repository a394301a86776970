"""deepseek-moe-16b [moe]: fine-grained 64 routed experts top-6 + 2 shared,
first layer dense (arXiv:2401.06066).  The sparse MLP runs in the dense
first layer; the MoE layers route (``layers/moe.py``)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register, default_sparse


@register("deepseek-moe-16b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=102400,
        n_experts=64, top_k=6, n_shared_experts=2, first_dense_layers=1,
        capacity_factor=1.25, router_norm_topk=True,
        tie_embeddings=True, activation="silu",
        sparse=default_sparse(),
        loss_chunk=1024,
    )
