"""Launcher of the sign-packing CUDA kernel (``csrc/sign_pack.cu``), the
counterpart of the Pallas kernel of ``repro/kernels/sign_pack.py``.

Layout: LSB-first along the last axis, bit ``b`` of word ``i`` is
``v[i*32 + b] < 0``; zero, -0.0 and the lanes past ``d`` pack as positive,
as ``core.predictor.pack_signs`` does.  Any ``d`` is taken: the kernel
reads the last word's missing lanes as zero.  Callers go through
``kernels.ops``, which picks the plain version for CPU tensors and counts
launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

PACK = 32
_V_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def sign_pack(v: torch.Tensor) -> torch.Tensor:
    """One launch: v (rows, d) float32 or bfloat16 on a CUDA device ->
    (rows, ceil(d/32)) int32."""
    if not v.is_cuda:
        raise ValueError("sign_pack launches on a CUDA tensor")
    if v.dtype not in _V_DTYPES:
        raise ValueError(f"sign_pack takes float32 or bfloat16, not "
                         f"{v.dtype}")
    if v.ndim != 2 or v.shape[0] < 1 or v.shape[1] < 1:
        raise ValueError(f"sign_pack takes (rows, d), got {tuple(v.shape)}")
    rows, d = v.shape
    v = v.contiguous()
    lib = build.load("sign_pack")
    out = torch.empty((rows, -(-d // PACK)), dtype=torch.int32,
                      device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = lib.sign_pack(v.data_ptr(), _V_DTYPES[v.dtype], out.data_ptr(),
                       rows, d, stream)
    build.check("sign_pack", rc)
    return out
