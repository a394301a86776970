"""The SparseInfer gated MLP: the counterpart of ``repro/core/sparse_mlp.py``.

Strategies:

``dense``   the baseline gated MLP (and the monolithic prefill path).
``masked``  predict and zero-mask: the full gate matmul, so its stats carry
            the exact false-negative rate (the controller's audit steps).
``gather``  predict -> per-group batch-union top-C selection -> gather of
            the selected row groups -> compact matmuls.  Plain ``torch``
            indexing and ``einsum``, as the reference's XLA path.
``pallas``  the two-kernel pipeline: the fused predictor kernel, a batch-
            union top-C selection, then the fused sparse-MLP kernel with
            in-kernel telemetry; a prefill chunk runs the chunk kernels and
            int8 weights the int8 kernels.  The name is the reference's own
            config string; here it names the CUDA kernels in ``csrc/``.

``masked`` and ``gather`` take their margins from the ``sign_pack`` and
``predict_counts`` kernels (``kernels/ops.py``).  Weights are
neuron-major: ``wg_t, wu_t, wd_t`` are (k, d), or their int8 leaves and
scales (``core/quantize.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import predictor as P
from repro_torch.core import quantize as Q
from repro_torch.core import selection as S
from repro_torch.core.relufication import get_activation, is_sparsifiable
from repro_torch.kernels import ops as kops

@dataclasses.dataclass(frozen=True)
class SparseInferConfig:
    """The paper's technique as configuration; fields and defaults are the
    reference's, so configs compare field for field."""

    enabled: bool = False
    # "pallas" is the reference's name for the two-kernel pipeline; in the
    # port it runs the two CUDA kernels of csrc/
    strategy: str = "gather"          # dense | masked | gather | pallas
    activation: str = "relu"
    alpha_base: float = 1.0
    alpha_early: float = 1.03
    alpha_early_frac: float = 0.5
    capacity_frac: float = 0.20
    group_size: int = 8
    use_actual_sparsity: bool = True
    sparse_max_batch: int = 16
    sparse_prefill: bool = False
    prefill_max_tokens: int = 128
    fatrelu_threshold: float = 0.0
    local_selection: bool = True
    capacity_buckets: tuple = ()
    capacity_override: int = 0
    tp_shards: int = 0
    dp_shards: int = 0
    shard_bucket_caps: tuple = ()
    weight_dtype: str = ""
    quant_group_size: int = 128

    def alpha_schedule(self) -> P.AlphaSchedule:
        return P.AlphaSchedule(self.alpha_base, self.alpha_early,
                               self.alpha_early_frac)

    def capacity(self, k: int) -> int:
        g = self.group_size
        n_groups = k // g
        if self.capacity_override:
            return min(self.capacity_override, n_groups)
        cap = max(1, int(round(n_groups * self.capacity_frac)))
        mult = max(1, 128 // g)                 # tile-aligned group counts
        cap = int(-(-cap // mult) * mult)
        return min(cap, n_groups)

    def capacity_ladder(self, k: int) -> tuple:
        """Aligned group counts of the capacity-bucket ladder (sorted,
        deduped; the static capacity when no buckets are set)."""
        if not self.capacity_buckets:
            return (self.capacity(k),)
        g = self.group_size
        n_groups = k // g
        mult = max(1, 128 // g)
        caps = set()
        for frac in self.capacity_buckets:
            cap = max(1, int(round(n_groups * float(frac))))
            cap = int(-(-cap // mult) * mult)
            caps.add(min(cap, n_groups))
        return tuple(sorted(caps))

    def shard_capacity(self, k: int) -> int:
        """Per-shard selection capacity (groups) under ``tp_shards``: the
        global capacity must split evenly, so every shard selects at one
        width.  With ``shard_bucket_caps`` (a per-shard bucket tuple) the
        width is the tuple's largest entry, and each shard clamps its own
        count to its entry (``runtime/distributed.py``)."""
        ms = max(1, self.tp_shards)
        if self.shard_bucket_caps:
            caps = tuple(int(c) for c in self.shard_bucket_caps)
            if len(caps) != ms:
                raise ValueError(
                    f"shard_bucket_caps has {len(caps)} entries but "
                    f"tp_shards={ms}")
            n_local = (k // self.group_size) // ms
            if any(c < 1 or c > n_local for c in caps):
                raise ValueError(
                    f"shard_bucket_caps {caps} out of range [1, {n_local}] "
                    f"local groups for k={k}, tp_shards={ms}, "
                    f"group_size={self.group_size}")
            return max(caps)
        cap = self.capacity(k)
        if cap % ms or (k // self.group_size) % ms:
            raise ValueError(
                f"capacity {cap} groups / k={k} not divisible by "
                f"tp_shards={ms} (group_size={self.group_size}): pick "
                "bucket fractions whose aligned group counts divide the "
                "shard count, or another group_size")
        return cap // ms


def init_gated_mlp(generator: torch.Generator, d: int, k: int,
                   dtype=torch.float32, gated: bool = True,
                   device="cpu") -> dict:
    """Neuron-major gated-MLP params drawn from ``generator``."""
    def draw(scale):
        return (torch.randn((k, d), generator=generator, device=device)
                * scale).to(dtype)
    params = {"wg_t": draw(d ** -0.5)}
    if gated:
        params["wu_t"] = draw(d ** -0.5)
    params["wd_t"] = draw(k ** -0.5)
    return params


def prepare_sparse_params(params: dict,
                          cfg: Optional[SparseInferConfig] = None) -> dict:
    """Offline step (paper Fig. 1): pack the gate weights' sign bits.  With
    ``cfg.weight_dtype == "int8"`` the float matrices are replaced by int8
    leaves and scales (``core/quantize.py``); the sign pack comes from the
    float weights either way."""
    if cfg is not None and cfg.weight_dtype:
        if cfg.weight_dtype != "int8":
            raise ValueError(f"unknown weight_dtype {cfg.weight_dtype!r}")
        return Q.quantize_mlp_node(params, cfg.quant_group_size,
                                   cfg.group_size)
    out = dict(params)
    out["sign_wg"] = kops.sign_pack(params["wg_t"])
    return out


def _act(cfg: SparseInferConfig):
    if cfg.activation == "fatrelu" or cfg.fatrelu_threshold > 0.0:
        return get_activation("fatrelu", cfg.fatrelu_threshold)
    return get_activation(cfg.activation)


# Telemetry contract: every return_stats call yields these float32 tensors
# shaped like the token dims of the input (see the reference module).
MLP_STAT_KEYS = (
    "predicted_density",
    "realized_density",
    "actual_density",
    "false_neg_rate",
    "overflow_frac",
    "union_demand_frac",
)

# Per-shard telemetry of a sharded (``tp_shards``) strategy, shaped token
# dims + (tp_shards,), beside the MLP_STAT_KEYS: each shard's realized
# density and its union's selection demand (selected + clamp-dropped
# groups), both as fractions of its own k/tp_shards rows.  The serve path's
# DistributedController pops them before aggregating the rest.
SHARD_STAT_KEY = "shard_realized_density"
SHARD_UNION_KEY = "shard_union_frac"
SHARD_RIDER_KEYS = (SHARD_STAT_KEY, SHARD_UNION_KEY)

# Alpha that makes any row predict all-sparse, so a dead slot drops out of
# the batch-union selection.
DEAD_SLOT_ALPHA = -1e9


def zero_mlp_stats(shape: tuple = (), device="cpu",
                   tp_shards: int = 0) -> dict:
    """Zero telemetry; ``tp_shards`` > 0 adds the per-shard riders, shaped
    ``shape + (tp_shards,)``."""
    out = {k: torch.zeros(shape, dtype=torch.float32, device=device)
           for k in MLP_STAT_KEYS}
    for k in SHARD_RIDER_KEYS if tp_shards else ():
        out[k] = torch.zeros(shape + (tp_shards,), dtype=torch.float32,
                             device=device)
    return out


def _stats(shape: tuple, device, **kw) -> dict:
    out = zero_mlp_stats(shape, device)
    for k, v in kw.items():
        out[k] = torch.as_tensor(v, dtype=torch.float32,
                                 device=device).broadcast_to(shape)
    return out


def dense_hidden(params: dict, x: torch.Tensor, cfg: SparseInferConfig):
    """The baseline MLP's hidden activations act(x Wg) * (x Wu) and its
    gate activations act(x Wg), of the float node (``Q.dense_view``)."""
    g1 = _act(cfg)(x @ params["wg_t"].to(x.dtype).T)
    h1 = g1
    if "wu_t" in params:
        h1 = h1 * (x @ params["wu_t"].to(x.dtype).T)
    return h1, g1


def dense_parts(params: dict, x: torch.Tensor, cfg: SparseInferConfig):
    """The baseline gated MLP (act(x Wg) * (x Wu)) Wd (paper eq. 1) and
    its gate activations act(x Wg); a quantized node multiplies its
    dequantized view."""
    params = Q.dense_view(params)
    h1, g1 = dense_hidden(params, x, cfg)
    return h1 @ params["wd_t"].to(x.dtype), g1


def dense_mlp(params: dict, x: torch.Tensor, cfg: SparseInferConfig,
              return_stats: bool = False):
    """Baseline gated MLP (``dense_parts``), with its telemetry."""
    y, g1 = dense_parts(params, x, cfg)
    if return_stats:
        return y, _stats(x.shape[:-1], x.device,
                         predicted_density=1.0, realized_density=1.0,
                         actual_density=(g1 > 0).float().mean(-1),
                         union_demand_frac=1.0)
    return y


def _margins(params: dict, x: torch.Tensor, alpha) -> torch.Tensor:
    """Per-token predictor margins (..., k): x's sign pack and the counts
    against the packed gate signs, each one kernel launch on the card."""
    sign_wg = params.get("sign_wg")
    if sign_wg is None:
        sign_wg = kops.sign_pack(params["wg_t"])
    return kops.predict_margins(sign_wg, kops.sign_pack(x), x.shape[-1],
                                alpha)


def masked_mlp(params: dict, x: torch.Tensor, cfg: SparseInferConfig,
               alpha=1.0, return_stats: bool = False):
    """Predict and zero-mask: the paper's skip semantics over the full gate
    matmul, so the stats include the exact false-negative rate (active
    neurons the predictor skipped).  ``alpha`` is a scalar or one value per
    token."""
    params = Q.dense_view(params)
    m = _margins(params, x, alpha)                          # (..., k)
    keep = (m <= 0).to(x.dtype)
    g1 = _act(cfg)(x @ params["wg_t"].to(x.dtype).T)
    h1 = g1 * keep
    if "wu_t" in params:
        h1 = h1 * (x @ params["wu_t"].to(x.dtype).T)
    y = h1 @ params["wd_t"].to(x.dtype)
    if not return_stats:
        return y
    active = g1 > 0
    k = m.shape[-1]
    # the keep fraction is a mean in x's dtype, as the reference takes it
    kept = keep.float().mean(-1).to(x.dtype)
    return y, _stats(
        x.shape[:-1], x.device,
        predicted_density=kept,
        realized_density=kept,                 # every predicted row computed
        actual_density=active.float().mean(-1),
        false_neg_rate=(active & (m > 0)).float().mean(-1),
        union_demand_frac=(m <= 0).reshape(-1, k).any(0).float().mean())


def gather_mlp(params: dict, x: torch.Tensor, cfg: SparseInferConfig,
               alpha=1.0, return_stats: bool = False):
    """Capacity-gather path: x (d,), (B, d) (one batch union) or (G, B, d)
    (a union and a selection per group G).  Per group: the batch-union
    margins, a top-C selection of row groups, the gather of those rows and
    compact matmuls.  A sharded config (``tp_shards``/``dp_shards``) runs
    its shard-local selections in ``runtime/distributed.py`` instead."""
    params = Q.dense_view(params)
    act = _act(cfg)
    squeeze = x.ndim == 1
    xb = x[None] if squeeze else x
    grouped_in = xb.ndim == 3
    xg = xb if grouped_in else xb[None]                     # (G, B, d)
    ngrp, b, d = xg.shape
    k = params["wg_t"].shape[0]
    g = cfg.group_size
    cap = cfg.capacity(k)

    m_tok = _margins(params, xg, alpha)                     # (G, B, k)
    gm = S.group_margins(m_tok.amin(1), g)                  # (G, k/g)
    sel, sstats = S.capacity_select_with_stats(gm, cap)     # (G, C)
    idx, valid = sel.indices, sel.valid

    def take_rows(w_t):                                     # (G, C*g, d)
        return S.take_row_groups(w_t.reshape(k // g, g, d), idx).reshape(
            ngrp, cap * g, d).to(xg.dtype)

    wg, wd = take_rows(params["wg_t"]), take_rows(params["wd_t"])
    vmask = valid.repeat_interleave(g, dim=-1).to(xg.dtype)  # (G, C*g)
    g1 = act(torch.einsum("gbd,gnd->gbn", xg, wg)) * vmask[:, None]
    h1 = g1
    if "wu_t" in params:
        h1 = h1 * torch.einsum("gbd,gnd->gbn", xg, take_rows(params["wu_t"]))
    if cfg.use_actual_sparsity:
        # the paper's +AS: rows whose gate is exactly zero add nothing
        h1 = torch.where(h1 != 0, h1, torch.zeros_like(h1))
    y = torch.einsum("gbn,gnd->gbd", h1, wd)                # (G, B, d)
    if not grouped_in:
        y = y[0]
    if squeeze:
        y = y[0]
    if not return_stats:
        return y
    # per token: the token's own predicted groups (a group survives if any
    # member does) and those of them the union selection kept; the union's
    # demand (selected + clamp-dropped) is a per-group quantity
    kf = torch.tensor(float(k), device=x.device)
    grp_keep = (m_tok.reshape(ngrp, b, k // g, g) <= 0).any(-1)
    sel_mask = S.mask_from_selection(sel, k // g)           # (G, k/g)
    pred_frac = grp_keep.float().mean(-1)                   # (G, B)
    real_frac = (grp_keep & sel_mask[:, None]).sum(
        -1, dtype=torch.float32) * g / kf
    union = (sel.count.float() * g / kf
             + sstats.overflow.float() * g / kf)[:, None]
    stats = _stats(
        (ngrp, b), x.device,
        predicted_density=pred_frac,
        realized_density=real_frac,
        actual_density=(g1 > 0).sum(-1).float() / kf,
        overflow_frac=torch.clamp(pred_frac - real_frac, min=0.0),
        union_demand_frac=union)
    if not grouped_in:
        stats = {kk: v[0] for kk, v in stats.items()}
    if squeeze:
        stats = {kk: v[0] for kk, v in stats.items()}
    return y, stats


def pallas_mlp(params: dict, x: torch.Tensor, cfg: SparseInferConfig,
               alpha=1.0, return_stats: bool = False):
    """Two-kernel sparse MLP: the fused predictor emits per-token per-group
    margins, a batch-union top-C selection picks the groups, and the fused
    MLP kernel computes only those (with per-token telemetry in-kernel).

    More than ``cfg.sparse_max_batch`` rows (a prefill chunk) run the
    chunk kernels: the rows form one union selection, as a decode batch's
    slots do.  A quantized node runs the int8 kernels."""
    squeeze = x.ndim == 1
    xb = x[None] if squeeze else x
    b, d = xb.shape
    quantized = Q.is_quantized(params)
    k = Q.mlp_hidden_rows(params)
    g = cfg.group_size
    cap = cfg.capacity(k)
    sign_wg = params.get("sign_wg")
    if sign_wg is None:
        sign_wg = kops.sign_pack(params["wg_t"])
    chunked = b > cfg.sparse_max_batch
    a = torch.as_tensor(alpha, dtype=torch.float32,
                        device=xb.device).broadcast_to((b,))
    predict = (kops.predict_chunk_group_margins if chunked
               else kops.predict_group_margins)
    gm_tok, pred_cnt = predict(sign_wg, xb, d, a, group_size=g)
    gm = S.union_margin(gm_tok)
    sel, sstats = S.capacity_select_with_stats(gm, cap)
    kw = dict(group_size=g, activation=cfg.activation,
              fatrelu_threshold=cfg.fatrelu_threshold,
              collect_stats=return_stats)
    tail = (sel.indices, sel.count, gm_tok if return_stats else None)
    if quantized:
        fused = (kops.fused_sparse_mlp_chunk_q if chunked
                 else kops.fused_sparse_mlp_q)
        out = fused(xb, params["wg_q"], params["wg_s"], params.get("wu_q"),
                    params.get("wu_s"), params["wd_q"], params["wd_s"],
                    *tail, **kw)
    else:
        fused = (kops.fused_sparse_mlp_chunk if chunked
                 else kops.fused_sparse_mlp)
        out = fused(xb, params["wg_t"], params.get("wu_t"), params["wd_t"],
                    *tail, **kw)
    if not return_stats:
        return out[0] if squeeze else out
    y, tel = out
    tel = tel.float()                                  # actual, fn, realized
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which can differ from the CPU's true division in the
    # last bit
    kf = torch.tensor(float(k), device=xb.device)
    predicted = pred_cnt.float() * g / kf
    realized = tel[:, 2] / kf
    stats = _stats(
        xb.shape[:-1], xb.device,
        predicted_density=predicted,
        realized_density=realized,
        actual_density=tel[:, 0] / kf,
        false_neg_rate=tel[:, 1] / kf,
        overflow_frac=torch.clamp(predicted - realized, min=0.0),
        union_demand_frac=sstats.predicted.float() * g / kf,
    )
    if squeeze:
        return y[0], {kk: v[0] for kk, v in stats.items()}
    return y, stats


def apply(params: dict, x: torch.Tensor, cfg: SparseInferConfig,
          alpha=None, layer_idx: int = 0, num_layers: int = 1,
          strategy: Optional[str] = None, **kw):
    """Dispatch the SparseInfer MLP by strategy with the per-layer alpha."""
    strategy = strategy or (cfg.strategy if cfg.enabled else "dense")
    if strategy != "dense" and not is_sparsifiable(cfg.activation):
        raise ValueError(
            f"SparseInfer needs a ReLU-fied activation, got {cfg.activation!r}")
    if alpha is None:
        alpha = cfg.alpha_schedule().alpha_for_layer(layer_idx, num_layers)
    if ((cfg.tp_shards or cfg.dp_shards)
            and strategy in ("masked", "gather", "pallas")):
        # shard-local selections over the (dp_shards, tp_shards) grid; a
        # local import, since runtime imports core
        from repro_torch.runtime import distributed as DD
        return DD.sharded_apply(params, x, cfg, alpha, strategy=strategy,
                                **kw)
    if strategy == "dense":
        return dense_mlp(params, x, cfg, **kw)
    if strategy == "masked":
        return masked_mlp(params, x, cfg, alpha, **kw)
    if strategy == "gather":
        return gather_mlp(params, x, cfg, alpha, **kw)
    if strategy == "pallas":
        return pallas_mlp(params, x, cfg, alpha, **kw)
    raise ValueError(f"unknown strategy {strategy!r}")
