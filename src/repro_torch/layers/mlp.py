"""MLP block with the SparseInfer hook: counterpart of
``repro/layers/mlp.py``.  Prefill runs dense (the paper sparsifies decode
only, §V-C); decode dispatches to the configured strategy."""
from __future__ import annotations

import torch

from repro_torch.core import sparse_mlp as SM
from repro_torch.core.sparse_mlp import SparseInferConfig


def init_mlp(generator: torch.Generator, d: int, k: int, gated: bool = True,
             dtype=torch.float32, device="cpu") -> dict:
    return SM.init_gated_mlp(generator, d, k, dtype=dtype, gated=gated,
                             device=device)


def mlp_apply(params: dict, x: torch.Tensor, cfg: SparseInferConfig, *,
              decode: bool = False, alpha=None, layer_idx: int = 0,
              num_layers: int = 1, return_stats: bool = False):
    """x: (..., d).  Dense unless ``decode`` and ``cfg.enabled``; a decode
    batch of more than ``sparse_max_batch`` tokens also runs dense — the
    reference's own semantics (one union selection serves at most that
    many tokens), not a device fallback.  ``alpha`` overrides the layer's
    schedule: a scalar or one value per token."""
    shape = x.shape

    def finish(out):
        if return_stats:
            y, stats = out
            stats = {k: stats[k].float() for k in SM.MLP_STAT_KEYS}
            return y.reshape(shape).to(x.dtype), stats
        return out.reshape(shape).to(x.dtype)

    if not (cfg.enabled and decode):
        return finish(SM.dense_mlp(params, x, cfg, return_stats=return_stats))
    xf = x.reshape(-1, shape[-1])
    if xf.shape[0] > cfg.sparse_max_batch:
        return finish(SM.dense_mlp(params, xf, cfg,
                                   return_stats=return_stats))
    return finish(SM.apply(params, xf, cfg, alpha=alpha, layer_idx=layer_idx,
                           num_layers=num_layers, return_stats=return_stats))
