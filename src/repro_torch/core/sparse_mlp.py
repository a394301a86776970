"""The SparseInfer gated MLP: the counterpart of ``repro/core/sparse_mlp.py``.

Ported strategies:

``dense``   the baseline gated MLP (and the monolithic prefill path).
``pallas``  the two-kernel pipeline: the fused predictor kernel, a batch-
            union top-C selection, then the fused sparse-MLP kernel with
            in-kernel telemetry; a prefill chunk runs the chunk kernels and
            int8 weights the int8 kernels.  The name is the reference's own
            config string; here it names the CUDA kernels in ``csrc/``.

``masked`` and ``gather`` are not ported yet and raise.
Weights are neuron-major: ``wg_t, wu_t, wd_t`` are (k, d), or their int8
leaves and scales (``core/quantize.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import predictor as P
from repro_torch.core import quantize as Q
from repro_torch.core import selection as S
from repro_torch.core.relufication import get_activation, is_sparsifiable

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
    out["sign_wg"] = P.pack_signs(params["wg_t"])
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

# Alpha that makes any row predict all-sparse, so a dead slot drops out of
# the batch-union selection.
DEAD_SLOT_ALPHA = -1e9


def zero_mlp_stats(shape: tuple = (), device="cpu") -> dict:
    return {k: torch.zeros(shape, dtype=torch.float32, device=device)
            for k in MLP_STAT_KEYS}


def _stats(shape: tuple, device, **kw) -> dict:
    out = zero_mlp_stats(shape, device)
    for k, v in kw.items():
        out[k] = torch.as_tensor(v, dtype=torch.float32,
                                 device=device).broadcast_to(shape)
    return out


def dense_mlp(params: dict, x: torch.Tensor, cfg: SparseInferConfig,
              return_stats: bool = False):
    """Baseline gated MLP: (act(x Wg) * (x Wu)) Wd (paper eq. 1); a
    quantized node multiplies its dequantized view."""
    params = Q.dense_view(params)
    g1 = _act(cfg)(x @ params["wg_t"].to(x.dtype).T)
    h1 = g1
    if "wu_t" in params:
        h1 = h1 * (x @ params["wu_t"].to(x.dtype).T)
    y = h1 @ params["wd_t"].to(x.dtype)
    if return_stats:
        return y, _stats(x.shape[:-1], x.device,
                         predicted_density=1.0, realized_density=1.0,
                         actual_density=(g1 > 0).float().mean(-1),
                         union_demand_frac=1.0)
    return y


def pallas_mlp(params: dict, x: torch.Tensor, cfg: SparseInferConfig,
               alpha=1.0, return_stats: bool = False):
    """Two-kernel sparse MLP: the fused predictor emits per-token per-group
    margins, a batch-union top-C selection picks the groups, and the fused
    MLP kernel computes only those (with per-token telemetry in-kernel).

    More than ``cfg.sparse_max_batch`` rows (a prefill chunk) run the
    chunk kernels: the rows form one union selection, as a decode batch's
    slots do.  A quantized node runs the int8 kernels."""
    from repro_torch.kernels import ops as kops
    squeeze = x.ndim == 1
    xb = x[None] if squeeze else x
    b, d = xb.shape
    quantized = Q.is_quantized(params)
    k = Q.mlp_hidden_rows(params)
    g = cfg.group_size
    cap = cfg.capacity(k)
    sign_wg = params.get("sign_wg")
    if sign_wg is None:
        sign_wg = P.pack_signs(params["wg_t"])
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
    if cfg.tp_shards or cfg.dp_shards:
        raise NotImplementedError(
            "sharded sparse decode is not ported yet (ROADMAP Queue A, "
            "sharded semantics)")
    if strategy == "dense":
        return dense_mlp(params, x, cfg, **kw)
    if strategy == "pallas":
        return pallas_mlp(params, x, cfg, alpha, **kw)
    if strategy in ("masked", "gather"):
        raise NotImplementedError(
            f"strategy {strategy!r} is not ported yet (ROADMAP Queue A, "
            "masked and gather strategies)")
    raise ValueError(f"unknown strategy {strategy!r}")
