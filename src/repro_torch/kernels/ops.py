"""Kernel wrappers with device dispatch: the counterpart of
``repro/kernels/ops.py`` for the kernels the port has.

A CPU tensor runs the plain PyTorch version (``kernels/ref.py``).  A CUDA
tensor launches the CUDA kernel or raises: there is no fallback.  Each
wrapper counts its launches (``launch_counts``), so a run can show that its
path went through the kernels.

A decode batch larger than a decode kernel takes (``MAX_BATCH`` rows) goes
to the chunk kernel of the same family, which computes the same function
row by row, and counts as a launch of that chunk kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import predictor as P
from repro_torch.kernels import paged_attn as _paged
from repro_torch.kernels import predict as _predict
from repro_torch.kernels import ref
from repro_torch.kernels import sign_pack as _sign_pack
from repro_torch.kernels import sparse_mlp_fused as _fused

_LAUNCHES = dict.fromkeys(
    ("predict_group_margins", "predict_chunk_group_margins",
     "fused_sparse_mlp", "fused_sparse_mlp_chunk", "fused_sparse_mlp_q",
     "fused_sparse_mlp_chunk_q", "paged_attention", "paged_kv_write",
     "sign_pack", "predict_counts"), 0)


def launch_counts() -> dict:
    """Kernel launches made through these wrappers since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def sign_pack(v: torch.Tensor) -> torch.Tensor:
    """Pack the sign bits of the last axis: (..., d) -> (..., ceil(d/32))
    int32, LSB-first.  Any ``d``: the kernel packs the last word's missing
    lanes as positive, as the plain version does."""
    if not v.is_cuda:
        return ref.sign_pack_ref(v)
    out = _sign_pack.sign_pack(v.reshape(-1, v.shape[-1]))
    _LAUNCHES["sign_pack"] += 1
    return out.reshape(v.shape[:-1] + (out.shape[-1],))


def predict_counts(packed_w: torch.Tensor,
                   packed_x: torch.Tensor) -> torch.Tensor:
    """Negative-product counts: ((k, w), (..., w)) -> (..., k) int32."""
    if not packed_x.is_cuda:
        return ref.predict_counts_ref(packed_w, packed_x)
    out = _predict.predict_counts(packed_w,
                                  packed_x.reshape(-1, packed_x.shape[-1]))
    _LAUNCHES["predict_counts"] += 1
    return out.reshape(packed_x.shape[:-1] + (packed_w.shape[0],))


def predict_margins(packed_w: torch.Tensor, packed_x: torch.Tensor,
                    d_valid: int, alpha=1.0) -> torch.Tensor:
    """Kernel-backed version of ``core.predictor.margins`` (paper eq. 2):
    the counts of :func:`predict_counts`, then the margin epilogue, bit for
    bit the plain version's."""
    return P.margins_from_counts(predict_counts(packed_w, packed_x), d_valid,
                                 alpha)


def _alpha(alpha, b: int, device) -> torch.Tensor:
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    return a.broadcast_to((b,)).contiguous()


def _predict_launch(chunked: bool, packed_w, x, d_valid: int, a,
                    group_size: int):
    chunked = chunked or x.shape[0] > _predict.MAX_BATCH
    pad = packed_w.shape[1] * _predict.PACK - x.shape[-1]
    xp = F.pad(x, (0, pad)) if pad else x
    launch = (_predict.predict_chunk_group_margins if chunked
              else _predict.predict_group_margins)
    out = launch(packed_w, xp, a, d_valid=d_valid, group_size=group_size)
    _LAUNCHES["predict_chunk_group_margins" if chunked
              else "predict_group_margins"] += 1
    return out


def predict_group_margins(packed_w: torch.Tensor, x: torch.Tensor,
                          d_valid: int, alpha=1.0, *, group_size: int = 8):
    """Fused predictor: x (B, d) -> per-token per-group margins (B, k/G)
    float32 and per-token counts of kept groups (B,) int32."""
    a = _alpha(alpha, x.shape[0], x.device)
    if not x.is_cuda:
        return ref.predict_group_margins_ref(packed_w, x, d_valid, a,
                                             group_size)
    return _predict_launch(False, packed_w, x, d_valid, a, group_size)


def predict_chunk_group_margins(packed_w: torch.Tensor, x: torch.Tensor,
                                d_valid: int, alpha=1.0, *,
                                group_size: int = 8):
    """Token-tiled predictor for prefill chunks (S rows): the contract of
    :func:`predict_group_margins`, row for row bitwise equal to it."""
    a = _alpha(alpha, x.shape[0], x.device)
    if not x.is_cuda:
        return ref.predict_chunk_group_margins_ref(packed_w, x, d_valid, a,
                                                   group_size)
    return _predict_launch(True, packed_w, x, d_valid, a, group_size)


def _mlp(name: str, plain, x, weights: tuple, sel_indices, sel_count,
         gm_tok, **kw):
    """The plain version on a CPU tensor; on a CUDA tensor the launch of
    ``name``, or of its chunk twin for more rows than a decode launch
    takes."""
    args = (*weights, sel_indices, sel_count, gm_tok)
    if not x.is_cuda:
        return plain(x, *args, **kw)
    if x.shape[0] > _fused.MAX_BATCH and "chunk" not in name:
        name = name.replace("fused_sparse_mlp", "fused_sparse_mlp_chunk")
    out = getattr(_fused, name)(x, *args, **kw)
    _LAUNCHES[name] += 1
    return out


def fused_sparse_mlp(x, wg_t, wu_t, wd_t, sel_indices, sel_count,
                     gm_tok=None, *, group_size: int = 8,
                     activation: str = "relu", fatrelu_threshold: float = 0.0,
                     collect_stats: bool = False):
    """Capacity-gathered fused sparse gated MLP: (B, d) -> (B, d) float32,
    plus the (B, 3) int32 telemetry with ``collect_stats``."""
    return _mlp("fused_sparse_mlp", ref.fused_sparse_mlp_stats_ref, x,
                (wg_t, wu_t, wd_t), sel_indices, sel_count, gm_tok,
                group_size=group_size, activation=activation,
                fatrelu_threshold=fatrelu_threshold,
                collect_stats=collect_stats)


def fused_sparse_mlp_chunk(x, wg_t, wu_t, wd_t, sel_indices, sel_count,
                           gm_tok=None, *, group_size: int = 8,
                           activation: str = "relu",
                           fatrelu_threshold: float = 0.0,
                           collect_stats: bool = False):
    """Row-tiled fused sparse MLP for prefill chunks: one chunk-union
    selection drives the whole chunk; the contract of
    :func:`fused_sparse_mlp`."""
    return _mlp("fused_sparse_mlp_chunk", ref.fused_sparse_mlp_chunk_ref, x,
                (wg_t, wu_t, wd_t), sel_indices, sel_count, gm_tok,
                group_size=group_size, activation=activation,
                fatrelu_threshold=fatrelu_threshold,
                collect_stats=collect_stats)


def fused_sparse_mlp_q(x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, sel_indices,
                       sel_count, gm_tok=None, *, group_size: int = 8,
                       activation: str = "relu",
                       fatrelu_threshold: float = 0.0,
                       collect_stats: bool = False):
    """int8-weight fused sparse MLP: the contract of
    :func:`fused_sparse_mlp` with int8 (k, d) leaves, ``wg_s``/``wu_s``
    (k, d/qg) and ``wd_s`` (k/qg, d) float32 scales."""
    return _mlp("fused_sparse_mlp_q", ref.fused_sparse_mlp_q_ref, x,
                (wg_q, wg_s, wu_q, wu_s, wd_q, wd_s), sel_indices, sel_count,
                gm_tok, group_size=group_size, activation=activation,
                fatrelu_threshold=fatrelu_threshold,
                collect_stats=collect_stats)


def fused_sparse_mlp_chunk_q(x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s,
                             sel_indices, sel_count, gm_tok=None, *,
                             group_size: int = 8, activation: str = "relu",
                             fatrelu_threshold: float = 0.0,
                             collect_stats: bool = False):
    """Row-tiled int8-weight fused sparse MLP for prefill chunks."""
    return _mlp("fused_sparse_mlp_chunk_q", ref.fused_sparse_mlp_chunk_q_ref,
                x, (wg_q, wg_s, wu_q, wu_s, wd_q, wd_s), sel_indices,
                sel_count, gm_tok, group_size=group_size,
                activation=activation, fatrelu_threshold=fatrelu_threshold,
                collect_stats=collect_stats)


def paged_attention(q, k_pages, v_pages, table, lengths, k_scale=None,
                    v_scale=None, *, softcap: float = 0.0, window: int = 0):
    """Paged decode attention over KV-pool pages: q (B, H, hd), pages
    (N, block, K, hd), table (B, nbps), lengths (B,) -> the normalized
    context (B, H, hd) float32.  An int8 pool (with its scales) runs only
    on the CPU here: on the card it takes the layer's gather route
    (``layers/attention.py:paged_decode_attend``), and the kernel raises."""
    if not q.is_cuda:
        return ref.paged_attention_ref(q, k_pages, v_pages, table, lengths,
                                       k_scale, v_scale, softcap=softcap,
                                       window=window)
    if k_scale is not None or v_scale is not None:
        raise ValueError("paged_attention: the CUDA kernel takes float32 "
                         "or bfloat16 pools, not int8 ones with scales")
    out = _paged.paged_attention(q, k_pages, v_pages, table, lengths,
                                 softcap=softcap, window=window)
    _LAUNCHES["paged_attention"] += 1
    return out


def paged_kv_write(pages, vals, blocks, offsets):
    """The decode step's KV write into the pool, in place:
    ``pages[blocks[b], offsets[b]] = vals[b]``, the last slot winning on a
    collision.  Returns ``pages``."""
    if not pages.is_cuda:
        return ref.paged_kv_write_ref(pages, vals, blocks, offsets)
    out = _paged.paged_kv_write(pages, vals, blocks, offsets)
    _LAUNCHES["paged_kv_write"] += 1
    return out
