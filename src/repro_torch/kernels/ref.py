"""Plain PyTorch versions of the port's kernels: what the CPU runs, and
what ``chip_smoke.py`` holds each CUDA kernel against on the card.  The
counterparts of ``repro/kernels/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.core import predictor as P
from repro_torch.core.relufication import get_activation


def _act(activation: str, fatrelu_threshold: float):
    return get_activation(
        "fatrelu" if (activation == "fatrelu" or fatrelu_threshold > 0.0)
        else activation, fatrelu_threshold)


def predict_group_margins_ref(packed_w: torch.Tensor, x: torch.Tensor,
                              d_valid: int, alpha: torch.Tensor,
                              group_size: int = 8):
    """Plain version of kernels.predict.predict_group_margins: pack ->
    margins -> group min -> per-token count of groups with margin <= 0."""
    m = P.margins(packed_w, P.pack_signs(x), d_valid, alpha)     # (B, k)
    b, k = m.shape
    gm = m.reshape(b, k // group_size, group_size).amin(-1)      # (B, k/G)
    cnt = (gm <= 0).sum(-1, dtype=torch.int32)                   # (B,)
    return gm, cnt


def _take_rows(w_t: torch.Tensor, sel_indices: torch.Tensor, g: int):
    k, d = w_t.shape
    return w_t.reshape(k // g, g, d)[sel_indices.long()].reshape(-1, d)


def fused_mlp_telemetry_ref(x, wg_t, sel_indices, sel_count, gm_tok, *,
                            group_size: int = 8, activation: str = "relu",
                            fatrelu_threshold: float = 0.0) -> torch.Tensor:
    """Plain version of the fused kernel's telemetry (B, 3) int32:
    (actual, false_neg, realized) row counts over the first ``sel_count``
    selected groups (kernels.sparse_mlp_fused.TELEMETRY_COLS)."""
    g = group_size
    cap = sel_indices.shape[0]
    act = _act(activation, fatrelu_threshold)
    valid = torch.arange(cap, device=x.device) < sel_count        # (C,)
    ga = act(x.float() @ _take_rows(wg_t, sel_indices, g).float().T)
    live = (ga > 0) & valid.repeat_interleave(g)[None, :]
    keep = gm_tok.float()[:, sel_indices.long()] <= 0             # (B, C)
    keep_row = keep.repeat_interleave(g, dim=-1)
    actual = live.sum(-1, dtype=torch.int32)
    fn = (live & ~keep_row).sum(-1, dtype=torch.int32)
    realized = (keep & valid[None, :]).sum(-1, dtype=torch.int32) * g
    return torch.stack([actual, fn, realized], dim=-1)


def fused_sparse_mlp_ref(x, wg_t, wu_t, wd_t, sel_indices, sel_count, *,
                         group_size: int = 8, activation: str = "relu",
                         fatrelu_threshold: float = 0.0) -> torch.Tensor:
    """Plain version of kernels.sparse_mlp_fused.fused_sparse_mlp: the
    capacity-gathered gated MLP over the first ``sel_count`` groups, f32.

    As the fused kernels do, ``h`` is rounded to ``x``'s dtype before the
    down projection (a no-op for float32 inputs)."""
    g = group_size
    cap = sel_indices.shape[0]
    act = _act(activation, fatrelu_threshold)
    valid = torch.arange(cap, device=x.device) < sel_count
    vmask = valid.repeat_interleave(g).float()
    xf = x.float()
    h = act(xf @ _take_rows(wg_t, sel_indices, g).float().T) * vmask
    if wu_t is not None:
        h = h * (xf @ _take_rows(wu_t, sel_indices, g).float().T)
    h = h.to(x.dtype).float()
    return h @ _take_rows(wd_t, sel_indices, g).float()
