"""Plain PyTorch versions of the port's kernels: what the CPU runs, and
what ``chip_smoke.py`` holds each CUDA kernel against on the card.  The
counterparts of ``repro/kernels/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.core import predictor as P
from repro_torch.core.relufication import get_activation


def _act(activation: str, fatrelu_threshold: float):
    return get_activation(
        "fatrelu" if (activation == "fatrelu" or fatrelu_threshold > 0.0)
        else activation, fatrelu_threshold)


def sign_pack_ref(v: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels.sign_pack.sign_pack: (..., d) ->
    (..., ceil(d/32)) int32 sign words, LSB-first."""
    return P.pack_signs(v)


def predict_counts_ref(packed_w: torch.Tensor,
                       packed_x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels.predict.predict_counts: (k, w) x (..., w)
    -> (..., k) int32 negative-product counts."""
    return P.neg_counts(packed_w, packed_x)


def predict_group_margins_ref(packed_w: torch.Tensor, x: torch.Tensor,
                              d_valid: int, alpha: torch.Tensor,
                              group_size: int = 8):
    """Plain version of kernels.predict.predict_group_margins: pack ->
    margins -> group min -> per-token count of groups with margin <= 0."""
    m = P.margins(packed_w, P.pack_signs(x), d_valid, alpha)     # (B, k)
    b, k = m.shape
    gm = m.reshape(b, k // group_size, group_size).amin(-1)      # (B, k/G)
    cnt = (gm <= 0).sum(-1, dtype=torch.int32)                   # (B,)
    return gm, cnt


def predict_chunk_group_margins_ref(packed_w: torch.Tensor, x: torch.Tensor,
                                    d_valid: int, alpha: torch.Tensor,
                                    group_size: int = 8):
    """Plain version of kernels.predict.predict_chunk_group_margins: its
    outputs are per row, so it is the decode predictor's plain version."""
    return predict_group_margins_ref(packed_w, x, d_valid, alpha, group_size)


def _take_rows(w_t: torch.Tensor, sel_indices: torch.Tensor, g: int):
    k, d = w_t.shape
    return w_t.reshape(k // g, g, d)[sel_indices.long()].reshape(-1, d)


def _telemetry(ga: torch.Tensor, keep: torch.Tensor, valid: torch.Tensor,
               g: int) -> torch.Tensor:
    """(B, 3) int32 telemetry from the gate activity ``ga`` (B, C*G), the
    token's own keep decision per selected group ``keep`` (B, C) and the
    groups inside the count ``valid`` (C,)."""
    live = (ga > 0) & valid.repeat_interleave(g)[None, :]
    keep_row = keep.repeat_interleave(g, dim=-1)
    actual = live.sum(-1, dtype=torch.int32)
    fn = (live & ~keep_row).sum(-1, dtype=torch.int32)
    realized = (keep & valid[None, :]).sum(-1, dtype=torch.int32) * g
    return torch.stack([actual, fn, realized], dim=-1)


def fused_mlp_telemetry_ref(x, wg_t, sel_indices, sel_count, gm_tok, *,
                            group_size: int = 8, activation: str = "relu",
                            fatrelu_threshold: float = 0.0) -> torch.Tensor:
    """Plain version of the fused kernel's telemetry (B, 3) int32:
    (actual, false_neg, realized) row counts over the first ``sel_count``
    selected groups (kernels.sparse_mlp_fused.TELEMETRY_COLS)."""
    g = group_size
    cap = sel_indices.shape[0]
    act = _act(activation, fatrelu_threshold)
    valid = torch.arange(cap, device=x.device) < sel_count        # (C,)
    ga = act(x.float() @ _take_rows(wg_t, sel_indices, g).float().T)
    keep = gm_tok.float()[:, sel_indices.long()] <= 0             # (B, C)
    return _telemetry(ga, keep, valid, g)


def fused_sparse_mlp_ref(x, wg_t, wu_t, wd_t, sel_indices, sel_count, *,
                         group_size: int = 8, activation: str = "relu",
                         fatrelu_threshold: float = 0.0) -> torch.Tensor:
    """Plain version of kernels.sparse_mlp_fused.fused_sparse_mlp: the
    capacity-gathered gated MLP over the first ``sel_count`` groups, f32.

    As the fused kernels do, ``h`` is rounded to ``x``'s dtype before the
    down projection (a no-op for float32 inputs)."""
    g = group_size
    cap = sel_indices.shape[0]
    act = _act(activation, fatrelu_threshold)
    valid = torch.arange(cap, device=x.device) < sel_count
    vmask = valid.repeat_interleave(g).float()
    xf = x.float()
    h = act(xf @ _take_rows(wg_t, sel_indices, g).float().T) * vmask
    if wu_t is not None:
        h = h * (xf @ _take_rows(wu_t, sel_indices, g).float().T)
    h = h.to(x.dtype).float()
    return h @ _take_rows(wd_t, sel_indices, g).float()


def fused_sparse_mlp_stats_ref(x, wg_t, wu_t, wd_t, sel_indices, sel_count,
                               gm_tok=None, *, group_size: int = 8,
                               activation: str = "relu",
                               fatrelu_threshold: float = 0.0,
                               collect_stats: bool = False):
    """The fused kernel's whole contract: y, and with ``collect_stats``
    (needs ``gm_tok``) also its telemetry."""
    kw = dict(group_size=group_size, activation=activation,
              fatrelu_threshold=fatrelu_threshold)
    y = fused_sparse_mlp_ref(x, wg_t, wu_t, wd_t, sel_indices, sel_count,
                             **kw)
    if not collect_stats:
        return y
    return y, fused_mlp_telemetry_ref(x, wg_t, sel_indices, sel_count,
                                      gm_tok, **kw)


def fused_sparse_mlp_chunk_ref(*args, **kw):
    """Plain version of kernels.sparse_mlp_fused.fused_sparse_mlp_chunk:
    row tiling changes no row's math, so it is the decode plain version."""
    return fused_sparse_mlp_stats_ref(*args, **kw)


def _qdot(xf: torch.Tensor, wq: torch.Tensor, s: torch.Tensor):
    """Quantized dot of the reference kernel's ``_qdot``: x (B, d) float32
    against C selected tiles wq (C, G, d) int8 with scales s (C, G, d/qg):
    one partial dot per quant group, times its scale, summed in ascending
    quant-group order -> (B, C, G) float32."""
    c, g, d = wq.shape
    nq = s.shape[-1]
    qg = d // nq
    part = torch.einsum("bqj,cgqj->bcgq", xf.reshape(-1, nq, qg),
                        wq.float().reshape(c, g, nq, qg))
    terms = part * s[None]
    acc = terms[..., 0]
    for q in range(1, nq):
        acc = acc + terms[..., q]
    return acc


def fused_sparse_mlp_q_ref(x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s,
                           sel_indices, sel_count, gm_tok=None, *,
                           group_size: int = 8, activation: str = "relu",
                           fatrelu_threshold: float = 0.0,
                           collect_stats: bool = False):
    """Plain version of kernels.sparse_mlp_fused.fused_sparse_mlp_q, in the
    reference kernel's op order: x taken as float32; gate and up through
    :func:`_qdot`; h NOT rounded to x's dtype; per selected group the down
    projection ``(h @ Wq_tile) * wd_s[sel // (qg/G)]``, added to y in
    selection order for the first ``sel_count`` groups; telemetry from the
    quantized gate.  Returns y (B, d) float32 [, telemetry (B, 3) int32]."""
    b, d = x.shape
    k = wg_q.shape[0]
    g = group_size
    qg = d // wg_s.shape[1]
    cap = sel_indices.shape[0]
    act = _act(activation, fatrelu_threshold)
    sel = sel_indices.long()
    valid = torch.arange(cap, device=x.device) < sel_count        # (C,)

    def tiles(w):
        return w.reshape(k // g, g, w.shape[-1])[sel]             # (C, G, .)

    xf = x.float()
    ga = act(_qdot(xf, tiles(wg_q), tiles(wg_s)))                 # (B, C, G)
    h = ga * _qdot(xf, tiles(wu_q), tiles(wu_s)) if wu_q is not None \
        else ga
    yd = torch.einsum("bcg,cgd->cbd", h, tiles(wd_q).float())
    yd = yd * wd_s[sel // (qg // g)][:, None, :]                  # (C, B, d)
    y = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    for c in range(cap):
        y = torch.where(valid[c], y + yd[c], y)
    if not collect_stats:
        return y
    keep = gm_tok.float()[:, sel] <= 0                            # (B, C)
    return y, _telemetry(ga.reshape(b, -1), keep, valid, g)


def fused_sparse_mlp_chunk_q_ref(*args, **kw):
    """Plain version of kernels.sparse_mlp_fused.fused_sparse_mlp_chunk_q:
    row tiling changes no row's math, so it is the decode q version."""
    return fused_sparse_mlp_q_ref(*args, **kw)


# ------------------------------------------------------- paged attention --

NEG_INF = -1e30     # layers/attention.py NEG_INF (the mask's value)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, table: torch.Tensor,
                        lengths: torch.Tensor, k_scale=None, v_scale=None,
                        *, softcap: float = 0.0,
                        window: int = 0) -> torch.Tensor:
    """Plain version of kernels.paged_attn.paged_attention: gather each
    slot's pool pages into its dense (B, S, K, hd) view, then the decode
    softmax at full cache width in the operation sequence of
    ``layers.attention.decode_attend_partial`` + normalize, so it is
    bitwise the port's dense decode on the same live tokens (stale lanes sit
    behind the NEG_INF mask with softmax weight exactly +0.0).

    q (B, H, hd); pages (N, block, K, hd) float32, bfloat16 or int8 (then
    with (N, block, K) ``k_scale``/``v_scale``); table (B, nbps) int32;
    lengths (B,) -> (B, H, hd) float32."""
    b, h, hd = q.shape
    _, bs, kvh, _ = k_pages.shape
    s_max = table.shape[1] * bs
    tab = table.long()
    int8 = k_pages.dtype == torch.int8

    def dense(p):
        return p[tab].reshape((b, s_max) + p.shape[2:])

    def compute(t):          # int8 values are multiplied as bfloat16
        return (t.to(torch.bfloat16) if int8 else t).float()

    kk, vv = dense(k_pages), dense(v_pages)
    op_dtype = torch.bfloat16 if int8 else k_pages.dtype
    qg = q.reshape(b, kvh, h // kvh, hd).to(op_dtype).float()
    s = torch.einsum("bkrh,btkh->bkrt", qg, compute(kk))
    # one folded constant, as the TPU kernel computes it
    if softcap > 0.0:
        s = torch.tanh(s * ((hd ** -0.5) / softcap)) * softcap
    else:
        s = s * (hd ** -0.5)
    if k_scale is not None:
        s = s * dense(k_scale).float().transpose(1, 2)[:, :, None, :]
    kvp = torch.arange(s_max, device=q.device)
    ln = lengths.long()[:, None]
    mask = kvp[None, :] <= ln
    if window > 0:
        mask = mask & ((ln - kvp[None, :]) < window)
    s = torch.where(mask[:, None, None, :], s,
                    torch.tensor(NEG_INF, device=s.device))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    if v_scale is not None:
        pv = p * dense(v_scale).float().transpose(1, 2)[:, :, None, :]
        o = torch.einsum("bkrt,btkh->bkrh", pv.to(torch.bfloat16).float(),
                         compute(vv))
    else:
        o = torch.einsum("bkrt,btkh->bkrh", p.to(vv.dtype).float(),
                         vv.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, h, hd)


def paged_kv_write_ref(pages: torch.Tensor, vals: torch.Tensor,
                       blocks: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels.paged_attn.paged_kv_write: in place,
    ``pages[blocks[b], offsets[b]] = vals[b]`` with collisions applied in
    slot order (the last slot wins, as on the TPU's sequential grid).  A
    slot that a later slot overwrites is dropped first, so the scatter's
    indices are unique and its result does not depend on the order
    ``index_put_`` takes.  Returns ``pages``."""
    key = blocks.long() * pages.shape[1] + offsets.long()
    later = torch.ones((key.shape[0],) * 2, dtype=torch.bool,
                       device=key.device).triu(1)
    keep = ~((key[:, None] == key[None, :]) & later).any(1)
    pages[blocks.long()[keep], offsets.long()[keep]] = \
        vals[keep].to(pages.dtype)
    return pages


def paged_write_target(table: torch.Tensor, cache_len: torch.Tensor,
                       bs: int) -> tuple:
    """Pool block and row of each slot's write position ``cache_len``:
    ``table[b, cache_len[b] // bs]`` and ``cache_len[b] % bs``."""
    blk = table.gather(1, (cache_len // bs)[:, None].to(torch.long))[:, 0]
    return blk, (cache_len % bs).to(torch.int32)


def paged_kv_write_pair_ref(k_pages: torch.Tensor, v_pages: torch.Tensor,
                            k_vals: torch.Tensor, v_vals: torch.Tensor,
                            table: torch.Tensor,
                            cache_len: torch.Tensor) -> None:
    """Plain version of kernels.paged_attn.paged_kv_write_pair: the targets
    from the table, then the K and the V write, in place."""
    blk, off = paged_write_target(table, cache_len, k_pages.shape[1])
    paged_kv_write_ref(k_pages, k_vals, blk, off)
    paged_kv_write_ref(v_pages, v_vals, blk, off)
