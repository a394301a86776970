"""Sign-bit XOR/popcount activation-sparsity predictor (paper §IV-A): the
plain PyTorch counterpart of ``repro/core/predictor.py``.

Weights are neuron-major (``wg_t`` is (k, d)); sign bits pack along ``d``
into int32 words, LSB-first: bit ``b`` of word ``i`` is ``v[i*32 + b] < 0``.
Zero and -0.0 pack as positive, and so do the pad lanes past ``d``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

PACK = 32  # sign bits per packed word (int32)

# popcount rows per chunk in neg_counts: bounds the (B, rows, w) int64
# intermediate of the plain version
_COUNT_CHUNK = 1024


def packed_width(d: int) -> int:
    """Number of int32 words needed to pack ``d`` sign bits."""
    return (d + PACK - 1) // PACK


def pack_signs(v: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., ceil(d/32)) int32 sign words, LSB-first."""
    d = v.shape[-1]
    w = packed_width(d)
    bits = (v < 0).to(torch.int64)
    if w * PACK - d:
        bits = torch.nn.functional.pad(bits, (0, w * PACK - d))
    bits = bits.reshape(v.shape[:-1] + (w, PACK))
    shifts = torch.arange(PACK, dtype=torch.int64, device=v.device)
    word = (bits << shifts).sum(-1)                       # in [0, 2^32)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def unpack_signs(packed: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`pack_signs` -> bool (..., d); True = negative."""
    words = packed.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(PACK, dtype=torch.int64, device=packed.device)
    bits = (words[..., None] >> shifts) & 1
    bits = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * PACK,))
    return bits[..., :d].to(torch.bool)


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Bit count of the low 32 bits of an int64 tensor (SWAR)."""
    v = v & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def neg_counts(packed_w: torch.Tensor, packed_x: torch.Tensor) -> torch.Tensor:
    """(k, w) x (..., w) -> (..., k) int32 predicted-negative product counts
    (sign bits that differ)."""
    lead = packed_x.shape[:-1]
    px = packed_x.reshape(-1, 1, packed_x.shape[-1]).to(torch.int64)
    pw = packed_w.to(torch.int64)
    out = []
    for r0 in range(0, pw.shape[0], _COUNT_CHUNK):
        xor = px ^ pw[None, r0:r0 + _COUNT_CHUNK]
        out.append(_popcount32(xor).sum(-1))
    return torch.cat(out, dim=-1).to(torch.int32).reshape(
        lead + (packed_w.shape[0],))


def margins(packed_w: torch.Tensor, packed_x: torch.Tensor, d_valid: int,
            alpha: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Prediction margin ``N_neg - alpha * N_pos`` (paper eq. 2), float32
    (..., k).  Positive => predicted sparse.

    ``alpha`` is a scalar or broadcasts against the batch dims of
    ``packed_x``.  The jitted reference contracts the multiply-subtract into
    one fused multiply-add; here the margin is computed in float64 — where
    it is exact for these operands — and rounded once to float32, which is
    the same single rounding, so margins agree bit for bit.
    """
    n_neg = neg_counts(packed_w, packed_x).to(torch.float64)
    a = torch.as_tensor(alpha, dtype=torch.float32,
                        device=packed_x.device).to(torch.float64)
    if a.ndim:
        a = a[..., None]
    return (n_neg - a * (float(d_valid) - n_neg)).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class AlphaSchedule:
    """Per-layer conservativeness schedule (paper §IV-A / §V-B): alpha
    slightly above 1.0 over the early layers, 1.0 for the rest."""

    base: float = 1.0
    early: float = 1.03
    early_frac: float = 0.5

    def alpha_for_layer(self, layer_idx: int, num_layers: int) -> float:
        cutoff = int(round(num_layers * self.early_frac))
        return self.early if layer_idx < cutoff else self.base

    def alphas(self, num_layers: int) -> np.ndarray:
        return np.asarray(
            [self.alpha_for_layer(i, num_layers) for i in range(num_layers)],
            dtype=np.float32)


def predictor_op_count(d: int, k: int) -> int:
    """Number of 32-bit XOR(+popcount) ops per token (paper Table I)."""
    return k * packed_width(d)


def predictor_sign_bytes(d: int, k: int) -> int:
    """Bytes of packed sign storage per weight matrix (paper §V-A2)."""
    return k * packed_width(d) * 4


def mlp_macs(d: int, k: int, gated: bool = True) -> int:
    """Dense MAC count of one gated-MLP block per token (paper Table I)."""
    return (3 if gated else 2) * d * k
