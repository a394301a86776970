"""Kernel wrappers with device dispatch: the counterpart of
``repro/kernels/ops.py`` for the kernels this slice ports.

A CPU tensor runs the plain PyTorch version (``kernels/ref.py``).  A CUDA
tensor launches the CUDA kernel or raises: there is no fallback.  Each
wrapper counts its launches (``launch_counts``), so a run can show that its
path went through the kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import predict as _predict
from repro_torch.kernels import ref
from repro_torch.kernels import sparse_mlp_fused as _fused

_LAUNCHES = {"predict_group_margins": 0, "fused_sparse_mlp": 0}


def launch_counts() -> dict:
    """Kernel launches made through these wrappers since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def predict_group_margins(packed_w: torch.Tensor, x: torch.Tensor,
                          d_valid: int, alpha=1.0, *, group_size: int = 8):
    """Fused predictor: x (B, d) -> per-token per-group margins (B, k/G)
    float32 and per-token counts of kept groups (B,) int32."""
    k, w = packed_w.shape
    b = x.shape[0]
    a = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    a = a.broadcast_to((b,)).contiguous()
    if not x.is_cuda:
        return ref.predict_group_margins_ref(packed_w, x, d_valid, a,
                                             group_size)
    pad = w * _predict.PACK - x.shape[-1]
    xp = F.pad(x, (0, pad)) if pad else x
    out = _predict.predict_group_margins(packed_w, xp, a, d_valid=d_valid,
                                         group_size=group_size)
    _LAUNCHES["predict_group_margins"] += 1
    return out


def fused_sparse_mlp(x, wg_t, wu_t, wd_t, sel_indices, sel_count,
                     gm_tok=None, *, group_size: int = 8,
                     activation: str = "relu", fatrelu_threshold: float = 0.0,
                     collect_stats: bool = False):
    """Capacity-gathered fused sparse gated MLP: (B, d) -> (B, d) float32,
    plus the (B, 3) int32 telemetry with ``collect_stats``."""
    kw = dict(group_size=group_size, activation=activation,
              fatrelu_threshold=fatrelu_threshold)
    if not x.is_cuda:
        y = ref.fused_sparse_mlp_ref(x, wg_t, wu_t, wd_t, sel_indices,
                                     sel_count, **kw)
        if not collect_stats:
            return y
        return y, ref.fused_mlp_telemetry_ref(x, wg_t, sel_indices,
                                              sel_count, gm_tok, **kw)
    out = _fused.fused_sparse_mlp(x, wg_t, wu_t, wd_t, sel_indices,
                                  sel_count, gm_tok,
                                  collect_stats=collect_stats, **kw)
    _LAUNCHES["fused_sparse_mlp"] += 1
    return out
