"""MLP block with the SparseInfer hook: counterpart of
``repro/layers/mlp.py``.  Prefill runs dense (the paper sparsifies decode
only, §V-C) unless ``sparse_prefill`` extends the batch-union selection to
the rows of a prefill chunk; decode dispatches to the configured strategy.
The dense MLP of a tensor-sharded config (``tp_shards`` > 1) is the sum of
its model shards' partials in ascending order
(``runtime/distributed.py:dense_apply``), so a rank mesh, whose ranks hold
their shards' rows only, computes it bitwise as one device does.  Outside
such a grid (the training forward on a mesh) ``row_shards`` > 1 says the
node holds this rank's share of rows split over the mesh's 'model' line:
its partial is summed over the line in rank order (``rules.model_sum``),
with a backward (``rules.model_entry`` on x)."""
from __future__ import annotations

import torch

from repro_torch.core import quantize as Q
from repro_torch.core import sparse_mlp as SM
from repro_torch.core.sparse_mlp import SparseInferConfig
from repro_torch.runtime import distributed as DD
from repro_torch.sharding import rules as R
from repro_torch.sharding import sparse as SSP


def init_mlp(generator: torch.Generator, d: int, k: int, gated: bool = True,
             dtype=torch.float32, device="cpu") -> dict:
    return SM.init_gated_mlp(generator, d, k, dtype=dtype, gated=gated,
                             device=device)


def mlp_apply(params: dict, x: torch.Tensor, cfg: SparseInferConfig, *,
              decode: bool = False, prefill: bool = False, alpha=None,
              layer_idx: int = 0, num_layers: int = 1,
              return_stats: bool = False, row_shards: int = 1):
    """x: (..., d).  Sparse when ``cfg.enabled`` and either ``decode`` or
    ``prefill`` with ``cfg.sparse_prefill`` (a chunk's rows then form one
    union selection, as a decode batch's slots do); dense otherwise.  More
    rows than ``prefill_max_tokens`` (prefill) or ``sparse_max_batch``
    (decode) also run dense — the reference's own semantics (one union
    selection serves at most that many rows), not a device fallback.  A
    sharded config (``tp_shards``/``dp_shards``) keeps prefill dense.
    ``alpha`` overrides the layer's schedule: a scalar or one value per
    row.  ``row_shards``: the dense MLP's rows are split over the current
    mesh's 'model' line this many ways (``models/common.py:mlp_shards``)."""
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
        return finish(_dense(params, x, cfg, return_stats, row_shards))
    xf = x.reshape(-1, shape[-1])
    max_rows = cfg.prefill_max_tokens if prefill else cfg.sparse_max_batch
    # a decode step on a mesh holds its 'data' line's slots: the limit
    # reads the whole batch, as on one device
    rows = xf.shape[0] * (1 if prefill else SSP.mesh_data_count())
    if rows > max_rows:
        return finish(_dense(params, xf, cfg, return_stats))
    return finish(SM.apply(params, xf, cfg, alpha=alpha, layer_idx=layer_idx,
                           num_layers=num_layers, return_stats=return_stats))


def _dense(params: dict, x: torch.Tensor, cfg: SparseInferConfig,
           return_stats: bool, row_shards: int = 1):
    """The dense MLP: a tensor-sharded config's in its shards' slices; a
    node of a rank's rows (``row_shards`` > 1) as its partial, taken in
    float32 on the operands rounded to x's dtype (as ``attention.
    _out_proj`` takes its own) and summed over the 'model' line."""
    if cfg.enabled and cfg.tp_shards > 1:
        return DD.dense_apply(params, x, cfg, return_stats=return_stats)
    if row_shards > 1:
        if return_stats:
            raise ValueError("the row-split dense MLP keeps no telemetry")
        params = Q.dense_view(params)
        h1, _ = SM.dense_hidden(params, R.model_entry(x), cfg)
        return R.model_sum(h1.float() @ params["wd_t"].to(x.dtype).float())
    return SM.dense_mlp(params, x, cfg, return_stats=return_stats)
