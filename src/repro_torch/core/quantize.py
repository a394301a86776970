"""Symmetric per-group int8 weight quantization for the sparse MLP: the
counterpart of ``repro/core/quantize.py``, with the same layout.

* ``wg_t`` / ``wu_t`` (k, d) contract over ``d``: quant groups of
  ``quant_group_size`` (qg) along d, scales (k, d/qg) float32.
* ``wd_t`` (k, d) contracts over ``k``: quant groups of qg along k, scales
  (k/qg, d) float32.  ``qg % group_size == 0`` puts every G-row selection
  tile inside one quant row group, so the down projection's dequant is one
  scale row per tile.

``sign_wg`` is packed from the float weights before they are dropped, so
the predictor selects the same groups with int8 weights as with float
ones.  Rounding is ``torch.round`` (half to even, as ``jnp.round``) and
clipping symmetric to +-127, so leaves and scales equal the reference's
bit for bit.  The helpers act on the trailing two axes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops

QMAX = 127.0

# quantized sparse-MLP leaf names (``wu_*`` only for a gated MLP); a node
# holds these and ``sign_wg``, or the float ``wg_t/wu_t/wd_t``, never both
QUANT_KEYS = ("wg_q", "wg_s", "wu_q", "wu_s", "wd_q", "wd_s")


def check_quant_dims(d: int, k: int, group_size: int, qg: int) -> None:
    """Raise ValueError unless qg >= 1 divides d and k and is a multiple of
    the selection group size."""
    if qg < 1:
        raise ValueError(f"quant_group_size must be >= 1, got {qg}")
    if d % qg:
        raise ValueError(f"d={d} not divisible by quant_group_size={qg} "
                         "(wg/wu scales group along d)")
    if k % qg:
        raise ValueError(f"k={k} not divisible by quant_group_size={qg} "
                         "(wd scales group along k)")
    if qg % group_size:
        raise ValueError(
            f"quant_group_size={qg} not divisible by group_size="
            f"{group_size}: every selection tile must lie inside one quant "
            "row group of wd")


def _absmax_scale(grp: torch.Tensor, dim: int) -> torch.Tensor:
    s = grp.abs().amax(dim) / QMAX
    return torch.where(s > 0, s, torch.ones_like(s))   # all-zero group: 1


def quantize_rows(w: torch.Tensor, qg: int):
    """Per-(row, d-group) absmax: (..., k, d) -> (int8 (..., k, d),
    float32 scales (..., k, d/qg))."""
    d = w.shape[-1]
    if d % qg:
        raise ValueError(f"d={d} not divisible by quant_group_size={qg}")
    grp = w.float().reshape(w.shape[:-1] + (d // qg, qg))
    s = _absmax_scale(grp, -1)
    q = torch.clamp(torch.round(grp / s[..., None]), -QMAX, QMAX)
    return q.to(torch.int8).reshape(w.shape), s


def quantize_cols(w: torch.Tensor, qg: int):
    """Per-(k-group, column) absmax: (..., k, d) -> (int8 (..., k, d),
    float32 scales (..., k/qg, d))."""
    k = w.shape[-2]
    if k % qg:
        raise ValueError(f"k={k} not divisible by quant_group_size={qg}")
    grp = w.float().reshape(w.shape[:-2] + (k // qg, qg, w.shape[-1]))
    s = _absmax_scale(grp, -2)
    q = torch.clamp(torch.round(grp / s[..., None, :]), -QMAX, QMAX)
    return q.to(torch.int8).reshape(w.shape), s


def dequant_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Row-grouped (wg/wu) leaves -> float32: int8 to float32, then times
    the group's scale."""
    d = q.shape[-1]
    qg = d // s.shape[-1]
    qf = q.float().reshape(q.shape[:-1] + (d // qg, qg))
    return (qf * s[..., None]).reshape(q.shape)


def dequant_cols(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Column-grouped (wd) leaves -> float32."""
    k = q.shape[-2]
    qg = k // s.shape[-2]
    qf = q.float().reshape(q.shape[:-2] + (k // qg, qg, q.shape[-1]))
    return (qf * s[..., None, :]).reshape(q.shape)


def is_quantized(params: dict) -> bool:
    return "wg_q" in params


def quant_group_size_of(params: dict) -> int:
    """qg recovered from the leaf shapes."""
    return params["wg_q"].shape[-1] // params["wg_s"].shape[-1]


def mlp_hidden_rows(params: dict) -> int:
    """The hidden width k of an MLP node, float or quantized."""
    w = params.get("wg_t")
    if w is None:
        w = params["wg_q"]
    return w.shape[-2]


def quantize_mlp_node(node: dict, qg: int, group_size: int = 8) -> dict:
    """A sparse-MLP node with int8 leaves and scales in place of its float
    matrices, and ``sign_wg`` packed from the float gate weights.  Other
    keys pass through."""
    wg = node["wg_t"]
    check_quant_dims(wg.shape[-1], wg.shape[-2], group_size, qg)
    out = {k: v for k, v in node.items() if k not in ("wg_t", "wu_t",
                                                      "wd_t")}
    out["sign_wg"] = kops.sign_pack(wg)
    out["wg_q"], out["wg_s"] = quantize_rows(wg, qg)
    if node.get("wu_t") is not None:
        out["wu_q"], out["wu_s"] = quantize_rows(node["wu_t"], qg)
    out["wd_q"], out["wd_s"] = quantize_cols(node["wd_t"], qg)
    return out


def dense_view(params: dict) -> dict:
    """Dequantized float32 view of a quantized node (float nodes pass
    through): what the dense MLP multiplies."""
    if "wg_q" not in params:
        return params
    out = {k: v for k, v in params.items() if k not in QUANT_KEYS}
    out["wg_t"] = dequant_rows(params["wg_q"], params["wg_s"])
    if params.get("wu_q") is not None:
        out["wu_t"] = dequant_rows(params["wu_q"], params["wu_s"])
    out["wd_t"] = dequant_cols(params["wd_q"], params["wd_s"])
    return out
