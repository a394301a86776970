"""xlstm-125m [xlstm]: sLSTM + mLSTM blocks, no FFN (d_ff=0)
(arXiv:2405.04517).  SparseInfer does not apply: the config has no MLP to
sparsify, so the arch runs without the technique."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register
from repro_torch.core.sparse_mlp import SparseInferConfig


@register("xlstm-125m")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="xlstm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
        d_ff=0, vocab=50304,
        slstm_every=4, tie_embeddings=True,
        sparse=SparseInferConfig(enabled=False),
        loss_chunk=4096,
    )
