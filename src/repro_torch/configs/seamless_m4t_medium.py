"""seamless-m4t-medium [encdec]: an encoder-decoder transformer backbone
(arXiv:2308.11596).  The audio frontend is a stub: inputs are precomputed
frame embeddings.  LayerNorm and a plain (ungated) ReLU FFN, so the
technique applies to the decoder FFNs directly (paper §III covers
Falcon/OPT-style MLPs)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register, default_sparse


@register("seamless-m4t-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec",
        n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16,
        n_kv_heads=16, head_dim=64, d_ff=4096, vocab=256206,
        n_frames=1024, norm="layernorm", activation="relu", gated_mlp=False,
        tie_embeddings=True,
        sparse=default_sparse(),
        loss_chunk=512,
    )
