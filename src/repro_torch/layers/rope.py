"""Rotary position embeddings: counterpart of ``repro/layers/rope.py``."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device="cpu") -> torch.Tensor:
    """Inverse frequencies (head_dim/2,) float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate pairs (split-half, llama-style).  x: (..., seq, heads, hd);
    positions broadcastable to (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs          # (..., seq, hd/2)
    angles = angles[..., None, :]                           # (..., seq, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
