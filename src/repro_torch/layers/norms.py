"""RMSNorm (functional, dict params): counterpart of
``repro/layers/norms.py``."""
from __future__ import annotations

import torch


def init_rmsnorm(d: int, dtype=torch.float32, device="cpu") -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm with the (1 + scale) parameterization, computed in float32
    and cast back to the input dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = params["scale"].float() + 1.0
    return (x * w).to(dtype)
