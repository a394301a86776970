"""Launcher of the fused predictor CUDA kernel
(``csrc/predict_group_margins.cu``), the counterpart of the Pallas kernel
``repro/kernels/predict.py:predict_group_margins``.

Callers go through ``kernels.ops``, which picks the plain version for CPU
tensors and counts launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

PACK = 32
MAX_BATCH = 16          # tokens a launch takes (SparseInferConfig
                        # .sparse_max_batch's default)
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def predict_group_margins(packed_w: torch.Tensor, x: torch.Tensor,
                          alpha: torch.Tensor, *, d_valid: int,
                          group_size: int = 8):
    """One launch: packed gate signs (k, w) int32, x (B, w*32) float32 or
    bfloat16 zero-padded past ``d_valid``, alpha (B,) float32, all on one
    CUDA device -> (gm (B, k/G) float32, cnt (B,) int32)."""
    k, w = packed_w.shape
    b, dp = x.shape
    if not (x.is_cuda and packed_w.device == x.device
            and alpha.device == x.device):
        raise ValueError("predict_group_margins launches on CUDA tensors of "
                         "one device")
    if x.dtype not in _X_DTYPES or packed_w.dtype != torch.int32 \
            or alpha.dtype != torch.float32:
        raise ValueError(f"unsupported dtypes x={x.dtype} "
                         f"packed_w={packed_w.dtype} alpha={alpha.dtype}")
    if dp != w * PACK or k % group_size or not 1 <= b <= MAX_BATCH \
            or alpha.shape != (b,):
        raise ValueError(f"bad shapes x={tuple(x.shape)} packed_w="
                         f"{tuple(packed_w.shape)} alpha={tuple(alpha.shape)}"
                         f" group_size={group_size}")
    x, packed_w, alpha = x.contiguous(), packed_w.contiguous(), \
        alpha.contiguous()
    lib = build.load("predict_group_margins")
    gm = torch.empty((b, k // group_size), dtype=torch.float32,
                     device=x.device)
    cnt = torch.zeros((b,), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.predict_group_margins(
        x.data_ptr(), _X_DTYPES[x.dtype], packed_w.data_ptr(),
        alpha.data_ptr(), gm.data_ptr(), cnt.data_ptr(), b, w, k,
        group_size, float(d_valid), stream)
    build.check("predict_group_margins", rc)
    return gm, cnt
