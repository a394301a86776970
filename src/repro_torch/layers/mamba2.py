"""Mamba2 (SSD) mixer: counterpart of ``repro/layers/mamba2.py``.

The chunked "state space dual" scan (Dao & Gu 2024, minimal-SSD form)
over a prompt, and the O(1)-state single-token decode.  A prompt of L
tokens runs in chunks of the largest divisor of L not above
``Mamba2Config.chunk`` (a prime L runs L chunks of 1), each chunk's
segment sums taken as differences of one cumulative sum, as the
reference takes them; a loop over the chunks carries the float32 SSM
state where the reference's ``lax.scan`` does, through
``layers/scan_utils.checkpointed_scan`` as the reference's: in training
only the states at sqrt-spaced chunk boundaries are kept for the backward
pass, and with autograd off it is the plain loop.

A state is a dict ``{"ssm": (B, H, P, N) float32, "conv": (B, d_conv - 1,
conv_dim)}``: the conv tail holds the last ``d_conv - 1`` inputs of the
depthwise conv before its activation, zero padding included after a short
prompt.  The recurrences are plain PyTorch ops: in the reference they are
``jnp`` outside any Pallas kernel, so there is no kernel to port here.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.layers.norms import init_rmsnorm, rmsnorm
from repro_torch.layers.scan_utils import checkpointed_scan


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64          # N
    head_dim: int = 64         # P
    expand: int = 2
    n_groups: int = 1          # G (B/C groups)
    d_conv: int = 4
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def _conv_dim(cfg: Mamba2Config) -> int:
    return cfg.d_inner + 2 * cfg.n_groups * cfg.d_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it:
    ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba2(generator: torch.Generator, cfg: Mamba2Config,
                dtype=torch.float32, device="cpu") -> dict:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    proj_out = 2 * di + 2 * cfg.n_groups * cfg.d_state + h

    def draw(shape, scale):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)
    u = torch.rand((h,), generator=generator, device=device)
    log_min, log_max = math.log(cfg.dt_min), math.log(cfg.dt_max)
    dt = torch.exp(u * (log_max - log_min) + log_min)
    return {
        "in_proj": draw((d, proj_out), d ** -0.5),
        "conv_w": draw((cfg.d_conv, _conv_dim(cfg)), cfg.d_conv ** -0.5),
        "conv_b": torch.zeros((_conv_dim(cfg),), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)),
        "D": torch.ones((h,), device=device),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "norm": init_rmsnorm(di, device=device),
        "out_proj": draw((di, d), di ** -0.5),
    }


def _split_proj(zxd: torch.Tensor, cfg: Mamba2Config):
    """The input projection -> (z, xBC, dt)."""
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    return (zxd[..., :di], zxd[..., di:2 * di + 2 * gn],
            zxd[..., 2 * di + 2 * gn:])


def _split_xbc(xbc: torch.Tensor, cfg: Mamba2Config):
    """The conv's output -> (x, B, C)."""
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    return xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., T) -> (..., T, T): entry (i, j) the sum of a over (j, i]
    for j <= i, as the difference of two cumulative sums; -inf above the
    diagonal."""
    t = a.shape[-1]
    cs = torch.cumsum(a, -1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return seg.masked_fill(~mask, float("-inf"))


def chunk_len(length: int, chunk: int) -> int:
    """The scan's chunk for a prompt of ``length`` tokens: the largest
    divisor of ``length`` not above ``chunk``."""
    k = max(1, min(chunk, length))
    while length % k:
        k -= 1
    return k


def mamba2_forward(params: dict, x: torch.Tensor, cfg: Mamba2Config,
                   return_state: bool = False):
    """x (B, L, d) -> (B, L, d) [, the state after the last token]."""
    b, l, _ = x.shape
    k = chunk_len(l, cfg.chunk)
    h, p, n, g = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    rep = h // g
    zxd = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt_raw = _split_proj(zxd, cfg)

    # causal depthwise conv (width d_conv), then silu
    pad = cfg.d_conv - 1
    xbc_p = F.pad(xbc, (0, 0, pad, 0))
    conv_w = params["conv_w"].to(x.dtype)
    conv = sum(xbc_p[:, i:i + l] * conv_w[i] for i in range(cfg.d_conv)) \
        + params["conv_b"].to(x.dtype)
    xs, bs, cs = _split_xbc(F.silu(conv), cfg)

    dt = _softplus(dt_raw.float() + params["dt_bias"])       # (B, L, H)
    da = dt * -torch.exp(params["A_log"])
    xs = xs.reshape(b, l, h, p)
    bs = bs.reshape(b, l, g, n)
    cs = cs.reshape(b, l, g, n)

    def chunk_step(state, inp):
        xc, bc, cc, dac, dtc = inp          # one chunk's K steps, batch-major
        xc = xc.float()                                      # (B, K, H, P)
        bc = bc.float().repeat_interleave(rep, 2)            # (B, K, H, N)
        cc = cc.float().repeat_interleave(rep, 2)
        dac = dac.transpose(1, 2)                            # (B, H, K)
        a_cum = torch.cumsum(dac, -1)
        lmat = torch.exp(_segsum(dac))                       # (B, H, K, K)
        xdt = xc * dtc[..., None]
        scores = torch.einsum("bihn,bjhn->bhij", cc, bc) * lmat
        y_diag = torch.einsum("bhij,bjhp->bihp", scores, xdt)
        decay = torch.exp(a_cum[..., -1:] - a_cum)           # (B, H, K)
        contrib = torch.einsum("bkhn,bkhp->bhpn",
                               bc * decay.transpose(1, 2)[..., None], xdt)
        y_off = torch.einsum("bkhn,bhpn->bkhp", cc, state) \
            * torch.exp(a_cum).transpose(1, 2)[..., None]
        state = state * torch.exp(a_cum[..., -1])[..., None, None] + contrib
        return state, (y_diag + y_off).to(x.dtype)

    def chunks(a):                  # (B, L, ...) -> (L / K, B, K, ...)
        return a.reshape((b, l // k, k) + a.shape[2:]).transpose(0, 1)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    # sqrt-BPTT over the chunks in training, the plain loop otherwise
    state, ys = checkpointed_scan(chunk_step, state, (
        chunks(xs), chunks(bs), chunks(cs), chunks(da), chunks(dt)))
    y = ys.transpose(0, 1).reshape(b, l, h, p) \
        + xs * params["D"][None, None, :, None]
    y = y.reshape(b, l, cfg.d_inner).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    out = y @ params["out_proj"].to(x.dtype)
    if return_state:
        return out, {"ssm": state, "conv": xbc_p[:, l:]}
    return out


def init_mamba2_state(batch: int, cfg: Mamba2Config, dtype=torch.bfloat16,
                      device="cpu") -> dict:
    return {"ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim,
                                cfg.d_state), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.d_conv - 1, _conv_dim(cfg)),
                                dtype=dtype, device=device)}


def mamba2_decode(params: dict, x: torch.Tensor, state: dict,
                  cfg: Mamba2Config):
    """One token.  x (B, 1, d) -> (y (B, 1, d), the new state)."""
    b = x.shape[0]
    h, p, n, g = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    rep = h // g
    zxd = x[:, 0] @ params["in_proj"].to(x.dtype)
    z, xbc, dt_raw = _split_proj(zxd, cfg)
    conv_in = torch.cat([state["conv"].to(x.dtype), xbc[:, None]], 1)
    conv = (conv_in * params["conv_w"].to(x.dtype)).sum(1) \
        + params["conv_b"].to(x.dtype)
    xs, bs, cs = _split_xbc(F.silu(conv), cfg)

    dt = _softplus(dt_raw.float() + params["dt_bias"])        # (B, H)
    da = torch.exp(dt * -torch.exp(params["A_log"]))
    xsh = xs.reshape(b, h, p).float()
    bsh = bs.reshape(b, g, n).repeat_interleave(rep, 1).float()
    csh = cs.reshape(b, g, n).repeat_interleave(rep, 1).float()
    upd = (xsh * dt[..., None])[..., None] * bsh[:, :, None, :]
    ssm = state["ssm"] * da[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", ssm, csh)
    y = y + xsh * params["D"][None, :, None]
    y = y.reshape(b, cfg.d_inner).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    out = (y @ params["out_proj"].to(x.dtype))[:, None]
    return out, {"ssm": ssm, "conv": conv_in[:, 1:]}
