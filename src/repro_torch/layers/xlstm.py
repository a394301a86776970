"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory,
recurrent): counterpart of ``repro/layers/xlstm.py`` (Beck et al. 2024,
stabilized exponential gating).

Both cells step through time in a loop carrying their state, where the
reference runs ``lax.scan``, through ``layers/scan_utils.
checkpointed_scan`` as the reference's: in training only the states at
sqrt-spaced time steps are kept for the backward pass, and with autograd
off it is the plain loop.  The products that do not depend on the
recurrence (the projections, the conv, the gates' input terms) run once
over the whole sequence.  States are dicts: mLSTM ``{"c": (B, H, dk,
dv), "n": (B, H, dk), "m": (B, H), "conv": (B, d_conv - 1, d_inner)}``
and sLSTM ``{"c", "n", "m", "h"}``, each (B, d); every leaf but the conv
tail is float32.
``init_mlstm_state`` and ``init_slstm_state`` start the stabilizer ``m`` at
-1e30, as a prefill does; ``models.lm.init_caches`` starts it at 0, as the
reference's does.  The recurrences are plain PyTorch ops: in the
reference they are ``jnp`` outside any Pallas kernel, so there is no kernel
to port here.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.layers.norms import init_rmsnorm, rmsnorm
from repro_torch.layers.scan_utils import checkpointed_scan


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int = 4
    expand: int = 2          # mLSTM up-projection factor
    d_conv: int = 4
    slstm_every: int = 4     # block i of a group is sLSTM when i == 1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def s_head_dim(self) -> int:
        return self.d_model // self.n_heads


def _drawer(generator, dtype, device):
    def draw(shape, scale):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)
    return draw


# ------------------------------------------------------------------ mLSTM --

def init_mlstm(generator: torch.Generator, cfg: XLSTMConfig,
               dtype=torch.float32, device="cpu") -> dict:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    s, si = d ** -0.5, di ** -0.5
    draw = _drawer(generator, dtype, device)
    return {
        "up": draw((d, 2 * di), s),
        "conv_w": draw((cfg.d_conv, di), cfg.d_conv ** -0.5),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "wq": draw((di, di), si),
        "wk": draw((di, di), si),
        "wv": draw((di, di), si),
        "w_if": draw((di, 2 * h), si),
        # input gates' bias 0, forget gates' 3
        "b_if": torch.cat([torch.zeros((h,), device=device),
                           torch.full((h,), 3.0, device=device)]).to(dtype),
        "norm": init_rmsnorm(di, device=device),
        "down": draw((di, d), si),
    }


def _mlstm_cell_step(state: tuple, q, k, v, log_i, log_f):
    """One time step of the stabilized mLSTM recurrence, in float32: state
    (c, n, m); q, k (B, H, dk) and v (B, H, dv) float32, the gates' logs
    (B, H).  Returns (the new state, h (B, H, dv) float32)."""
    c, n, m = state
    m_new = torch.maximum(log_f + m, log_i)
    f_s = torch.exp(log_f + m - m_new)[..., None, None]
    i_s = torch.exp(log_i - m_new)[..., None, None]
    c = f_s * c + i_s * (k[..., :, None] * v[..., None, :])
    n = f_s[..., 0] * n + i_s[..., 0] * k
    num = (q[..., None, :] @ c)[..., 0, :]
    den = torch.maximum((n * q).sum(-1).abs(),
                        torch.exp(-m_new))[..., None]
    return (c, n, m_new), num / den


def _mlstm_qkvg(params: dict, x: torch.Tensor, cfg: XLSTMConfig,
                conv_prev: torch.Tensor):
    """The projections over x (B, L, d), the conv continuing from the
    ``conv_prev`` tail: q and k from the conv's activation, v from the
    input before the conv, k scaled by dk^-0.5.  Returns (q, k, v, log_i,
    log_f, z, the new conv tail)."""
    b, l, _ = x.shape
    di, h, hd = cfg.d_inner, cfg.n_heads, cfg.head_dim
    xm, z = torch.chunk(x @ params["up"].to(x.dtype), 2, dim=-1)
    xm_p = torch.cat([conv_prev.to(x.dtype), xm], 1)
    conv_w = params["conv_w"].to(x.dtype)
    conv = sum(xm_p[:, i:i + l] * conv_w[i] for i in range(cfg.d_conv)) \
        + params["conv_b"].to(x.dtype)
    xc = F.silu(conv)
    q = (xc @ params["wq"].to(x.dtype)).reshape(b, l, h, hd)
    k = (xc @ params["wk"].to(x.dtype)).reshape(b, l, h, hd) * hd ** -0.5
    v = (xm @ params["wv"].to(x.dtype)).reshape(b, l, h, hd)
    gates = xc @ params["w_if"].to(x.dtype) + params["b_if"].to(x.dtype)
    log_i = gates[..., :h].float()
    log_f = F.logsigmoid(gates[..., h:].float())
    return q, k, v, log_i, log_f, z, xm_p[:, l:]


def mlstm_forward(params: dict, x: torch.Tensor, cfg: XLSTMConfig,
                  state: dict | None = None, return_state: bool = False):
    """x (B, L, d) -> (B, L, d) [, the state after the last token]; the
    recurrence continues from ``state`` (default: a fresh one)."""
    b, l, _ = x.shape
    if state is None:
        state = init_mlstm_state(b, cfg, x.dtype, x.device)
    q, k, v, log_i, log_f, z, conv_tail = _mlstm_qkvg(params, x, cfg,
                                                      state["conv"])
    def step(carry, inp):
        carry, h_t = _mlstm_cell_step(carry, *inp)
        return carry, h_t.to(v.dtype)
    seq = tuple(a.float().transpose(0, 1) for a in (q, k, v, log_i, log_f))
    carry, hs = checkpointed_scan(step, (state["c"], state["n"],
                                         state["m"]), seq)
    hs = hs.transpose(0, 1).reshape(b, l, cfg.d_inner).to(x.dtype)
    out = rmsnorm(params["norm"], hs) * F.silu(z)
    out = out @ params["down"].to(x.dtype)
    if return_state:
        c, n, m = carry
        return out, {"c": c, "n": n, "m": m, "conv": conv_tail}
    return out


def init_mlstm_state(batch: int, cfg: XLSTMConfig, dtype=torch.bfloat16,
                     device="cpu") -> dict:
    h, hd = cfg.n_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, h, hd, hd), **f32),
            "n": torch.zeros((batch, h, hd), **f32),
            "m": torch.full((batch, h), -1e30, **f32),
            "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                                dtype=dtype, device=device)}


def mlstm_decode(params: dict, x: torch.Tensor, state: dict,
                 cfg: XLSTMConfig):
    """x (B, 1, d) -> (y (B, 1, d), the new state)."""
    return mlstm_forward(params, x, cfg, state, return_state=True)


# ------------------------------------------------------------------ sLSTM --

def init_slstm(generator: torch.Generator, cfg: XLSTMConfig,
               dtype=torch.float32, device="cpu") -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.s_head_dim
    s = d ** -0.5
    draw = _drawer(generator, dtype, device)
    return {
        # the input projections of the gates i, f, z, o
        "w": draw((d, 4 * d), s),
        # block-diagonal recurrent weights, a block a head: (H, hd, 4 hd)
        "r": draw((h, hd, 4 * hd), hd ** -0.5),
        "b": torch.cat([torch.zeros((d,), device=device),
                        torch.full((d,), 3.0, device=device),
                        torch.zeros((2 * d,), device=device)]).to(dtype),
        "norm": init_rmsnorm(d, device=device),
        "out": draw((d, d), s),
    }


def _slstm_step(params: dict, cfg: XLSTMConfig, state: dict,
                xw: torch.Tensor) -> dict:
    """One time step; ``xw`` (B, 4d) is the input's projection ``x_t @ w``
    in x's dtype.  The recurrent term is head-blocked: head j's (4, hd)
    outputs land at gate g's columns ``g * d + j * hd``."""
    b = xw.shape[0]
    h, hd = cfg.n_heads, cfg.s_head_dim
    hx = state["h"].reshape(b, h, hd).to(xw.dtype)
    rec = torch.einsum("bhi,hio->bho", hx, params["r"].to(xw.dtype))
    rec = rec.reshape(b, h, 4, hd).transpose(1, 2).reshape(b, 4 * h * hd)
    gates = (xw + rec + params["b"].to(xw.dtype)).float()
    gi, gf, gz, go = torch.chunk(gates, 4, dim=-1)
    log_f = F.logsigmoid(gf)
    m_new = torch.maximum(log_f + state["m"], gi)
    f_s = torch.exp(log_f + state["m"] - m_new)
    i_s = torch.exp(gi - m_new)
    c = f_s * state["c"] + i_s * torch.tanh(gz)
    n = f_s * state["n"] + i_s
    hid = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "m": m_new, "h": hid}


def slstm_forward(params: dict, x: torch.Tensor, cfg: XLSTMConfig,
                  state: dict | None = None, return_state: bool = False):
    """x (B, L, d) -> (B, L, d) [, the state after the last token]: the
    strict recurrence over time from ``state`` (default: a fresh one)."""
    b, l, _ = x.shape
    if state is None:
        state = init_slstm_state(b, cfg, x.device)
    xw = x @ params["w"].to(x.dtype)

    def step(st, xw_t):
        st = _slstm_step(params, cfg, st, xw_t)
        return st, st["h"]
    state, hs = checkpointed_scan(step, state, xw.transpose(0, 1))
    hs = hs.transpose(0, 1).to(x.dtype)
    out = rmsnorm(params["norm"], hs) @ params["out"].to(x.dtype)
    if return_state:
        return out, state
    return out


def init_slstm_state(batch: int, cfg: XLSTMConfig, device="cpu") -> dict:
    d = cfg.d_model

    def zeros():
        return torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"c": zeros(), "n": zeros(),
            "m": torch.full((batch, d), -1e30, dtype=torch.float32,
                            device=device),
            "h": zeros()}


def slstm_decode(params: dict, x: torch.Tensor, state: dict,
                 cfg: XLSTMConfig):
    """x (B, 1, d) -> (y (B, 1, d), the new state)."""
    new = _slstm_step(params, cfg, state, x[:, 0] @ params["w"].to(x.dtype))
    out = rmsnorm(params["norm"], new["h"][:, None].to(x.dtype))
    return out @ params["out"].to(x.dtype), new
