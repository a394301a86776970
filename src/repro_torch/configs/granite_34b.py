"""granite-34b [dense]: llama-arch code model, MQA (kv=1), non-gated
GELU FFN (arXiv:2405.04324). SparseInfer applies to the plain MLP after
ReLUfication (paper SIII covers OPT/Falcon-style MLPs)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register, default_sparse


@register("granite-34b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
        d_ff=24576, vocab=49152,
        tie_embeddings=True, activation="gelu", gated_mlp=False,
        sparse=default_sparse(),
        pure_fsdp_train=True,        # EXPERIMENTS.md SPerf: ZeRO-3 beats TP here
        loss_chunk=2048,
    )
