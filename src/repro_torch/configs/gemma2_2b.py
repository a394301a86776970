"""gemma2-2b [dense]: local+global alternating attention, logit softcaps,
pre+post block norms, GeGLU (arXiv:2408.00118)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register, default_sparse


@register("gemma2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=9216, vocab=256000,
        window=4096, local_global_period=2,
        attn_softcap=50.0, final_softcap=30.0, post_block_norm=True,
        embed_scale=True, tie_embeddings=True, activation="gelu",
        sparse=default_sparse(),     # ReLU-fied GeGLU -> ReGLU for decode
        loss_chunk=512,              # 256k vocab: keep logits chunks small
    )
