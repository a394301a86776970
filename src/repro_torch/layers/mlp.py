"""MLP block with the SparseInfer hook: counterpart of
``repro/layers/mlp.py``.  Prefill runs dense (the paper sparsifies decode
only, §V-C) unless ``sparse_prefill`` extends the batch-union selection to
the rows of a prefill chunk; decode dispatches to the configured strategy."""
from __future__ import annotations

import torch

from repro_torch.core import sparse_mlp as SM
from repro_torch.core.sparse_mlp import SparseInferConfig


def init_mlp(generator: torch.Generator, d: int, k: int, gated: bool = True,
             dtype=torch.float32, device="cpu") -> dict:
    return SM.init_gated_mlp(generator, d, k, dtype=dtype, gated=gated,
                             device=device)


def mlp_apply(params: dict, x: torch.Tensor, cfg: SparseInferConfig, *,
              decode: bool = False, prefill: bool = False, alpha=None,
              layer_idx: int = 0, num_layers: int = 1,
              return_stats: bool = False):
    """x: (..., d).  Sparse when ``cfg.enabled`` and either ``decode`` or
    ``prefill`` with ``cfg.sparse_prefill`` (a chunk's rows then form one
    union selection, as a decode batch's slots do); dense otherwise.  More
    rows than ``prefill_max_tokens`` (prefill) or ``sparse_max_batch``
    (decode) also run dense — the reference's own semantics (one union
    selection serves at most that many rows), not a device fallback.  A
    sharded config (``tp_shards``/``dp_shards``) keeps prefill dense.
    ``alpha`` overrides the layer's schedule: a scalar or one value per
    row."""
    shape = x.shape

    def finish(out):
        if return_stats:
            y, stats = out
            # the contract's keys, plus the sharded strategies' per-shard
            # riders; a dense path of a tensor-sharded config emits zero
            # riders, so its stats stack against the sharded layers'
            keys = SM.MLP_STAT_KEYS + tuple(
                k for k in SM.SHARD_RIDER_KEYS if k in stats)
            stats = {k: stats[k].float() for k in keys}
            if cfg.tp_shards:
                tok = stats["realized_density"].shape
                for rk in SM.SHARD_RIDER_KEYS:
                    if rk not in stats:
                        stats[rk] = torch.zeros(
                            tok + (cfg.tp_shards,), dtype=torch.float32,
                            device=x.device)
            return y.reshape(shape).to(x.dtype), stats
        return out.reshape(shape).to(x.dtype)

    sparse = cfg.enabled and (decode or (prefill and cfg.sparse_prefill))
    if prefill and (cfg.tp_shards or cfg.dp_shards):
        sparse = False    # the reference keeps a sharded prefill dense
    if not sparse:
        return finish(SM.dense_mlp(params, x, cfg, return_stats=return_stats))
    xf = x.reshape(-1, shape[-1])
    max_rows = cfg.prefill_max_tokens if prefill else cfg.sparse_max_batch
    if xf.shape[0] > max_rows:
        return finish(SM.dense_mlp(params, xf, cfg,
                                   return_stats=return_stats))
    return finish(SM.apply(params, xf, cfg, alpha=alpha, layer_idx=layer_idx,
                           num_layers=num_layers, return_stats=return_stats))
