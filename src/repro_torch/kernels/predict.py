"""Launchers of the predictor CUDA kernels, the counterparts of the Pallas
kernels of ``repro/kernels/predict.py``:

* ``predict_group_margins`` (``csrc/predict_group_margins.cu``): a decode
  batch of at most ``MAX_BATCH`` tokens;
* ``predict_chunk_group_margins`` (``csrc/predict_chunk_group_margins.cu``):
  a prefill chunk of any number of rows, tiled over tokens;
* ``predict_counts`` (``csrc/predict_counts.cu``): the paper's Listing-1
  negative-product counts from pre-packed signs, any number of rows.

The first two instantiate ``csrc/predict_margins.cuh``, so every row's
outputs are bitwise the same from either.  Callers go through
``kernels.ops``, which picks the plain version for CPU tensors and counts
launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

PACK = 32
MAX_BATCH = 16          # tokens a decode launch takes (SparseInferConfig
                        # .sparse_max_batch's default)
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(name: str, packed_w: torch.Tensor, x: torch.Tensor,
            alpha: torch.Tensor, d_valid: int, group_size: int):
    k, w = packed_w.shape
    b, dp = x.shape
    if not (x.is_cuda and packed_w.device == x.device
            and alpha.device == x.device):
        raise ValueError(f"{name} launches on CUDA tensors of one device")
    if x.dtype not in _X_DTYPES or packed_w.dtype != torch.int32 \
            or alpha.dtype != torch.float32:
        raise ValueError(f"unsupported dtypes x={x.dtype} "
                         f"packed_w={packed_w.dtype} alpha={alpha.dtype}")
    max_b = MAX_BATCH if name == "predict_group_margins" else b
    if dp != w * PACK or k % group_size or not 1 <= b <= max_b \
            or alpha.shape != (b,):
        raise ValueError(f"bad shapes for {name}: x={tuple(x.shape)} "
                         f"packed_w={tuple(packed_w.shape)} "
                         f"alpha={tuple(alpha.shape)} group_size={group_size}")
    x, packed_w, alpha = x.contiguous(), packed_w.contiguous(), \
        alpha.contiguous()
    lib = build.load(name)
    gm = torch.empty((b, k // group_size), dtype=torch.float32,
                     device=x.device)
    cnt = torch.zeros((b,), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, name)(
        x.data_ptr(), _X_DTYPES[x.dtype], packed_w.data_ptr(),
        alpha.data_ptr(), gm.data_ptr(), cnt.data_ptr(), b, w, k,
        group_size, float(d_valid), stream)
    build.check(name, rc)
    return gm, cnt


def predict_group_margins(packed_w: torch.Tensor, x: torch.Tensor,
                          alpha: torch.Tensor, *, d_valid: int,
                          group_size: int = 8):
    """One launch: packed gate signs (k, w) int32, x (B <= 16, w*32)
    float32 or bfloat16 zero-padded past ``d_valid``, alpha (B,) float32,
    all on one CUDA device -> (gm (B, k/G) float32, cnt (B,) int32)."""
    return _launch("predict_group_margins", packed_w, x, alpha, d_valid,
                   group_size)


def predict_chunk_group_margins(packed_w: torch.Tensor, x: torch.Tensor,
                                alpha: torch.Tensor, *, d_valid: int,
                                group_size: int = 8):
    """:func:`predict_group_margins` for any number of rows S (a prefill
    chunk), one launch tiled over tokens."""
    return _launch("predict_chunk_group_margins", packed_w, x, alpha,
                   d_valid, group_size)


def predict_counts(packed_w: torch.Tensor,
                   packed_x: torch.Tensor) -> torch.Tensor:
    """One launch: packed gate signs (k, w) int32 and packed x (B, w)
    int32, on one CUDA device -> (B, k) int32 counts of sign bits that
    differ."""
    k, w = packed_w.shape
    if not (packed_x.is_cuda and packed_w.device == packed_x.device):
        raise ValueError("predict_counts launches on CUDA tensors of one "
                         "device")
    if packed_w.dtype != torch.int32 or packed_x.dtype != torch.int32:
        raise ValueError(f"unsupported dtypes packed_w={packed_w.dtype} "
                         f"packed_x={packed_x.dtype}")
    if packed_x.ndim != 2 or packed_x.shape[1] != w or k < 1 or w < 1 \
            or packed_x.shape[0] < 1:
        raise ValueError(f"bad shapes for predict_counts: packed_w="
                         f"{tuple(packed_w.shape)} packed_x="
                         f"{tuple(packed_x.shape)}")
    b = packed_x.shape[0]
    packed_w, packed_x = packed_w.contiguous(), packed_x.contiguous()
    lib = build.load("predict_counts")
    out = torch.empty((b, k), dtype=torch.int32, device=packed_x.device)
    stream = torch.cuda.current_stream(packed_x.device).cuda_stream
    rc = lib.predict_counts(packed_w.data_ptr(), packed_x.data_ptr(),
                            out.data_ptr(), b, w, k, stream)
    build.check("predict_counts", rc)
    return out
