"""Launchers of the fused predictor CUDA kernels, the counterparts of the
Pallas kernels of ``repro/kernels/predict.py``:

* ``predict_group_margins`` (``csrc/predict_group_margins.cu``): a decode
  batch of at most ``MAX_BATCH`` tokens;
* ``predict_chunk_group_margins`` (``csrc/predict_chunk_group_margins.cu``):
  a prefill chunk of any number of rows, tiled over tokens.

Both instantiate ``csrc/predict_margins.cuh``, so every row's outputs are
bitwise the same from either.  Callers go through ``kernels.ops``, which
picks the plain version for CPU tensors and counts launches."""
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
