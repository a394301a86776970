"""Sharded sparse decode: the counterpart of
``repro/runtime/distributed.py``.

Two config fields define the semantics, whatever the placement:

``SparseInferConfig.tp_shards`` (ms): the FFN hidden dim k splits into ms
contiguous row slices.  Each model shard holds its slice of the packed gate
signs and of the three neuron-major matrices (the sign bits pack along d,
which stays whole, so its margins need nothing from other shards), takes
its own batch union over its k/ms rows and its own top-C/ms selection
(``shard_capacity``), or, under the per-shard bucket ladder, clamps its
count to its entry of ``shard_bucket_caps``
(``core.selection.clamp_selection``).  It yields a partial down projection
and its telemetry as neuron counts.

``SparseInferConfig.dp_shards`` (ds): the B batch slots split into ds
contiguous blocks of B/ds.  Each block runs its own union and selection
per model shard, so a block's selection never reads another block's
tokens.

``emulated_apply`` runs the (ds, ms) grid as a loop on one device: a
(block, shard) tile is ``_local_mlp``; a block's partials are summed over
the shards in ascending order in float32 (``_combine_gathered``, never an
atomic), its integer-valued counts summed exactly, so the result is bitwise
the same in every run.  The rows of each weight leaf a shard reads are a
view of the layer's leaf, never a copy.

``shard_map_apply`` runs the same grid on a ``launch.mesh.RankMesh`` of
``torch.distributed`` ranks whose axes divide it: each rank holds its
model tiles' rows of the MLP leaves (``sharding/sparse.py``) and gets the
rows of its 'data' line's slots (``sharding/rules.py:slot_range``), loops
over its (data block, model tile) tiles through the same ``_local_mlp``,
gathers the packed partials with each tile's count matrix over its 'model'
line in rank order into the same ``_combine_gathered`` and sums the counts
(exact: they are integers), so what it returns is bitwise the line's rows
of ``emulated_apply``'s.  Nothing is gathered over 'data': the server
gathers a decode step's tokens and telemetry over it once a step
(``runtime/server.py``).  ``sharded_apply`` dispatches to
it under ``sharding.rules.use_mesh`` of more than one rank.  The dense MLP
of a tensor-sharded config (the prefill) is ``dense_apply``: the shards'
partials summed in the same fixed order, on one device or on the mesh.

A moe config's MoE layers run no sparse MLP: they report zero stats with
zero riders (``models/lm.py``), so its dense first layers' riders stack
against them, one row a layer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import quantize as Q
from repro_torch.core import selection as S
from repro_torch.core import sparse_mlp as SM
from repro_torch.kernels import ops as kops
from repro_torch.sharding import rules as R
from repro_torch.sharding import sparse as SSP

# summed count columns, in order (each (B,) float32 neuron counts;
# overflow_frac follows as predicted - realized)
COUNT_COLS = ("predicted", "realized", "actual", "false_neg", "union")

# trailing columns packed beside the output partials: a shard's realized
# and union counts (the per-shard riders)
_RIDER_COLS = 2


def semantic_grid(cfg: SM.SparseInferConfig) -> tuple[int, int]:
    """The (ds, ms) shard grid of a config (1 = an unsharded axis)."""
    return max(1, cfg.dp_shards or 1), max(1, cfg.tp_shards or 1)


def shard_caps(cfg: SM.SparseInferConfig, k: int) -> tuple[tuple, int]:
    """Each model shard's effective capacity in groups and the selection
    width (the largest of them).  A uniform config gives
    ``((cap_l,) * ms, cap_l)``."""
    _, ms = semantic_grid(cfg)
    cap_l = cfg.shard_capacity(k)
    if cfg.shard_bucket_caps:
        return tuple(int(c) for c in cfg.shard_bucket_caps), cap_l
    return (cap_l,) * ms, cap_l


def _take_groups(w_t: torch.Tensor, sel: S.Selection, g: int):
    """The selected row groups of one local (k_l, d) matrix."""
    k_l, d = w_t.shape
    out = S.take_row_groups(w_t.reshape(k_l // g, g, d), sel.indices)
    return out.reshape(-1, d)


# ------------------------------------------------------- shard-local math --

def _local_mlp(sign_l, params_l: dict, x: torch.Tensor,
               cfg: SM.SparseInferConfig, alpha: torch.Tensor, strategy: str,
               cap_l: int, cap_eff: Optional[int], collect: bool,
               x_signs: Optional[torch.Tensor] = None):
    """One (data block, model shard) tile's partial MLP.

    ``cap_l`` is the selection width, ``cap_eff`` (None: no clamp) the
    shard's own bucket capacity; ``alpha`` is (B,) float32 and ``x_signs``
    x's packed signs (masked and gather; packed once a block).  Returns
    ``(y_partial (B, d) float32, counts or None)``, the counts a dict over
    ``COUNT_COLS`` of (B,) float32 neuron counts over the shard's rows.
    pallas runs the predictor kernel and the fused MLP kernel (float32 or
    int8 weights); masked and gather take their margins from the
    ``predict_counts`` kernel."""
    act = SM._act(cfg)
    b, d = x.shape
    k_l = Q.mlp_hidden_rows(params_l)
    g = cfg.group_size
    quantized = Q.is_quantized(params_l)
    gated = (params_l.get("wu_t") is not None
             or params_l.get("wu_q") is not None)

    if strategy == "pallas":
        gm_tok, pred_cnt = kops.predict_group_margins(sign_l, x, d, alpha,
                                                      group_size=g)
        sel, sstats = S.capacity_select_with_stats(S.union_margin(gm_tok),
                                                   cap_l)
        if cap_eff is not None:
            sel, sstats = S.clamp_selection(sel, sstats, cap_eff)
        kw = dict(group_size=g, activation=cfg.activation,
                  fatrelu_threshold=cfg.fatrelu_threshold,
                  collect_stats=collect)
        tail = (sel.indices, sel.count, gm_tok if collect else None)
        if quantized:
            out = kops.fused_sparse_mlp_q(
                x, params_l["wg_q"], params_l["wg_s"], params_l.get("wu_q"),
                params_l.get("wu_s"), params_l["wd_q"], params_l["wd_s"],
                *tail, **kw)
        else:
            out = kops.fused_sparse_mlp(
                x, params_l["wg_t"], params_l.get("wu_t"), params_l["wd_t"],
                *tail, **kw)
        if not collect:
            return out, None
        y, tel = out
        tel = tel.float()                          # actual, fn, realized
        return y, {
            "predicted": pred_cnt.float() * g,
            "realized": tel[:, 2],
            "actual": tel[:, 0],
            "false_neg": tel[:, 1],
            "union": (sstats.predicted.float() * g).broadcast_to((b,)),
        }

    if quantized:
        # masked and gather multiply the dequantized float32 view
        params_l = Q.dense_view(params_l)
    if x_signs is None:
        x_signs = kops.sign_pack(x)
    m_tok = kops.predict_margins(sign_l, x_signs, d, alpha)     # (B, k_l)

    if strategy == "masked":
        keep = m_tok <= 0
        g1 = act(x @ params_l["wg_t"].to(x.dtype).T)
        h1 = g1 * keep.to(x.dtype)
        if gated:
            h1 = h1 * (x @ params_l["wu_t"].to(x.dtype).T)
        y = (h1 @ params_l["wd_t"].to(x.dtype)).float()
        if not collect:
            return y, None
        active = g1 > 0
        kept = keep.sum(-1, dtype=torch.float32)
        return y, {
            "predicted": kept,
            "realized": kept,                      # no clamp on this path
            "actual": active.sum(-1, dtype=torch.float32),
            "false_neg": (active & (m_tok > 0)).sum(-1, dtype=torch.float32),
            "union": keep.any(0).sum(dtype=torch.float32).broadcast_to((b,)),
        }

    if strategy != "gather":
        raise ValueError(f"unknown sharded strategy {strategy!r}")
    gm_tok = S.group_margins(m_tok, g)                          # (B, k_l/G)
    sel, sstats = S.capacity_select_with_stats(S.union_margin(gm_tok), cap_l)
    if cap_eff is not None:
        sel, sstats = S.clamp_selection(sel, sstats, cap_eff)
    wg = _take_groups(params_l["wg_t"], sel, g).to(x.dtype)
    wd = _take_groups(params_l["wd_t"], sel, g).to(x.dtype)
    vmask = sel.valid.repeat_interleave(g).to(x.dtype)          # (cap_l*G,)
    g1 = act(x @ wg.T) * vmask[None]
    h1 = g1
    if gated:
        h1 = h1 * (x @ _take_groups(params_l["wu_t"], sel, g).to(x.dtype).T)
    if cfg.use_actual_sparsity:
        h1 = torch.where(h1 != 0, h1, torch.zeros_like(h1))
    y = (h1 @ wd).float()
    if not collect:
        return y, None
    grp_keep = gm_tok <= 0
    sel_mask = S.mask_from_selection(sel, k_l // g)
    return y, {
        "predicted": grp_keep.sum(-1, dtype=torch.float32) * g,
        "realized": (grp_keep & sel_mask[None]).sum(
            -1, dtype=torch.float32) * g,
        "actual": (g1 > 0).sum(-1, dtype=torch.float32),
        "false_neg": torch.zeros((b,), dtype=torch.float32, device=x.device),
        "union": ((sel.count + sstats.overflow).float() * g).broadcast_to(
            (b,)),
    }


# ----------------------------------------------------- combine + epilogue --

def _pack_partial(y: torch.Tensor, counts: dict) -> torch.Tensor:
    """(B, d) partial and the (realized, union) columns -> (B, d+2): what
    one gather across devices would move."""
    return torch.cat([y, counts["realized"][:, None],
                      counts["union"][:, None]], dim=-1)


def _combine_gathered(gathered: torch.Tensor, collect: bool, k_l: int):
    """The fixed-order shard combine: the (ms, B, ·) partials summed in
    ascending shard order in float32, one add at a time, so every run (and
    any placement of the same grid) reduces in the same order."""
    total = gathered[0]
    for s in range(1, gathered.shape[0]):
        total = total + gathered[s]
    if not collect:
        return total
    kl = torch.tensor(float(k_l), device=gathered.device)
    y = total[..., :-_RIDER_COLS]
    shard_real = gathered[..., -2].T / kl                      # (B, ms)
    shard_union = gathered[..., -1].T / kl                     # (B, ms)
    return y, shard_real, shard_union


def _finalize_stats(totals: dict, shard_real, shard_union, k: int,
                    tp_shards: int) -> dict:
    """Summed neuron counts -> the ``MLP_STAT_KEYS`` contract per token,
    plus the per-shard riders of a tensor-sharded config (a data-only grid
    has no model shard to tell apart)."""
    p0 = totals["predicted"]
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which can differ from the CPU's true division
    kf = torch.tensor(float(k), device=p0.device)
    p = p0 / kf
    r = totals["realized"] / kf
    stats = SM._stats(
        p.shape, p.device,
        predicted_density=p,
        realized_density=r,
        actual_density=totals["actual"] / kf,
        false_neg_rate=totals["false_neg"] / kf,
        overflow_frac=torch.clamp(p - r, min=0.0),
        union_demand_frac=totals["union"] / kf,
    )
    if tp_shards:
        stats[SM.SHARD_STAT_KEY] = shard_real
        stats[SM.SHARD_UNION_KEY] = shard_union
    return stats


# the sliceable MLP leaves: each one's rows are proportional to k (float
# matrices and int8 leaves have k rows, wd's scales k/qg), so shard s's
# slice of a leaf of r*ms rows is rows [s*r, (s+1)*r)
_SLICE_KEYS = ("wg_t", "wu_t", "wd_t",
               "wg_q", "wg_s", "wu_q", "wu_s", "wd_q", "wd_s")


def _slice_rows(params: dict, s: int, ms: int) -> dict:
    """Shard s's rows of the MLP leaves: row views, no copy."""
    local = {}
    for name in _SLICE_KEYS:
        w = params.get(name)
        if w is None:
            continue
        r = w.shape[0] // ms
        if r * ms != w.shape[0]:
            raise ValueError(
                f"{name} {tuple(w.shape)}: {w.shape[0]} rows do not split "
                f"over tp_shards={ms} (int8: k/ms must be a multiple of "
                "the quant group)")
        local[name] = w[s * r:(s + 1) * r]
    return local


def _slice_params(params: dict, sign_wg: torch.Tensor, s: int,
                  ms: int) -> tuple:
    """Shard s's packed gate signs and MLP leaves: row views, no copy."""
    k_l = Q.mlp_hidden_rows(params) // ms
    return sign_wg[s * k_l:(s + 1) * k_l], _slice_rows(params, s, ms)


def _check_views(slices: list, x: torch.Tensor, bt: int) -> None:
    """On the card the kernels read weights and x in 16-byte copies: every
    shard's row views and every data block must start 16-byte aligned
    (d % 4 == 0 for float32 rows; d * elem % 16 == 0 for a block of x).
    Raises rather than copy a layer's weights every step."""
    if not x.is_cuda:
        return
    for s, (sign_l, local) in enumerate(slices):
        for name, w in (("sign_wg", sign_l), *local.items()):
            if w.data_ptr() % 16:
                raise ValueError(
                    f"shard {s}'s rows of {name} {tuple(w.shape)} start "
                    "off a 16-byte boundary: the kernels take no copy")
    for db in range(x.shape[0] // bt):
        if x[db * bt].data_ptr() % 16:
            raise ValueError(
                f"data block {db} of x {tuple(x.shape)} ({x.dtype}) starts "
                "off a 16-byte boundary: d * elem must be a multiple of 16")


def _count_matrix_one(counts: dict) -> torch.Tensor:
    """One tile's count dict -> (B, n), the ``COUNT_COLS`` in order."""
    return torch.stack([counts[col] for col in COUNT_COLS], dim=-1)


def _count_matrix(counts_by_shard: list) -> torch.Tensor:
    """One data block's per-shard count dicts -> (B, n), summed over the
    shards (integer-valued float32: exact in any order)."""
    cmat = torch.stack([_count_matrix_one(c) for c in counts_by_shard],
                       dim=0)                                # (ms, B, n)
    return cmat.sum(0)


# ------------------------------------------------------------ public API --

def _grid_inputs(params: dict, x: torch.Tensor, cfg: SM.SparseInferConfig,
                 alpha, m_mesh: int = 1, d_mesh: int = 1):
    """What every grid loop needs: (ds, ms, k, caps, cap_l, clamp, the
    slices of the model tiles ``params`` holds, the block height, the
    alphas of x's rows).  ``params`` holds 1/``m_mesh`` of the k rows: a
    rank's ms/m_mesh tiles; x holds 1/``d_mesh`` of the slots: a rank's
    ds/d_mesh data blocks."""
    ds, ms = semantic_grid(cfg)
    k = Q.mlp_hidden_rows(params) * m_mesh
    caps, cap_l = shard_caps(cfg, k)
    sign_wg = params.get("sign_wg")
    if sign_wg is None:
        sign_wg = kops.sign_pack(params["wg_t"])
    b, per_d = x.shape[0], ds // d_mesh
    if b % per_d:
        raise ValueError(f"batch {b} not divisible by dp_shards={ds}"
                         + (f" over {d_mesh} 'data' lines" if d_mesh > 1
                            else ""))
    bt = b // per_d
    per_m = ms // m_mesh
    slices = [_slice_params(params, sign_wg, s, per_m)
              for s in range(per_m)]
    _check_views(slices, x, bt)
    a = torch.as_tensor(alpha, dtype=torch.float32,
                        device=x.device).broadcast_to((b,))
    return (ds, ms, k, caps, cap_l, bool(cfg.shard_bucket_caps), slices, bt,
            a)


def emulated_apply(params: dict, x: torch.Tensor, cfg: SM.SparseInferConfig,
                   alpha, *, strategy: str, return_stats: bool = False):
    """The (ds, ms) semantics on one device: a loop over data blocks and
    model shards through ``_local_mlp`` and the fixed-order combine.  x is
    (B, d); returns y (B, d) float32 [and the stats, the per-shard riders
    (B, ms) among them when ``tp_shards`` is set]."""
    ds, ms, k, caps, cap_l, clamp, slices, bt, a = _grid_inputs(
        params, x, cfg, alpha)
    y_blocks, tot_blocks, real_blocks, union_blocks = [], [], [], []
    for db in range(ds):
        x_t = x[db * bt:(db + 1) * bt]
        a_t = a[db * bt:(db + 1) * bt]
        x_signs = kops.sign_pack(x_t) if strategy != "pallas" else None
        parts, counts = [], []
        for s, (sign_l, params_l) in enumerate(slices):
            y_s, c_s = _local_mlp(sign_l, params_l, x_t, cfg, a_t, strategy,
                                  cap_l, caps[s] if clamp else None,
                                  return_stats, x_signs)
            parts.append(_pack_partial(y_s, c_s) if return_stats else y_s)
            if return_stats:
                counts.append(c_s)
        gathered = torch.stack(parts, dim=0)              # (ms, bt, d[+2])
        if not return_stats:
            y_blocks.append(_combine_gathered(gathered, False, k // ms))
            continue
        y_t, real_t, union_t = _combine_gathered(gathered, True, k // ms)
        y_blocks.append(y_t)
        tot_blocks.append(_count_matrix(counts))
        real_blocks.append(real_t)
        union_blocks.append(union_t)
    y = torch.cat(y_blocks, dim=0)
    if not return_stats:
        return y
    totals_mat = torch.cat(tot_blocks, dim=0)                     # (B, n)
    totals = {col: totals_mat[:, i] for i, col in enumerate(COUNT_COLS)}
    return y, _finalize_stats(totals, torch.cat(real_blocks, dim=0),
                              torch.cat(union_blocks, dim=0), k,
                              cfg.tp_shards)


def _mesh_sizes(cfg: SM.SparseInferConfig, mesh) -> tuple[int, int]:
    """The ('model', 'data') sizes of ``mesh``, which must divide the
    config's grid; (1, 1) without a mesh."""
    if mesh is None:
        return 1, 1
    d_mesh, m_mesh = SSP.mesh_divides(*semantic_grid(cfg), mesh)
    return m_mesh, d_mesh


def _gather_rows(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The ``axis`` line's ranks' ``t`` concatenated along dim 0 in rank
    order."""
    return R.gather_line(t, axis, mesh).flatten(0, 1)


def shard_map_apply(params: dict, x: torch.Tensor,
                    cfg: SM.SparseInferConfig, alpha, *, mesh,
                    strategy: str, return_stats: bool = False):
    """The (ds, ms) semantics on the ranks of ``mesh``, whose 'data' and
    'model' axes divide them.  ``params`` holds this rank's rows of the MLP
    leaves (ms/m_mesh contiguous model tiles); x (B/d_mesh, d) and
    ``alpha`` are the slots of this rank's 'data' line
    (``rules.slot_range``): its ds/d_mesh data blocks, the same on every
    rank of the line.  Each rank runs its blocks x its tiles through
    ``_local_mlp``; one collective follows: the packed partials, each
    tile's count matrix beside its partial, gathered over the 'model' line
    in rank order (then ``_combine_gathered``, and the counts summed).
    Nothing crosses the 'data' axis: a line's rows and counts stay on it.
    Returns the line's rows of what ``emulated_apply`` returns for every
    slot, bitwise, on every rank of the line."""
    m_mesh, d_mesh = _mesh_sizes(cfg, mesh)
    ds, ms, k, caps, cap_l, clamp, slices, bt, a = _grid_inputs(
        params, x, cfg, alpha, m_mesh, d_mesh)
    per_m, per_d = ms // m_mesh, ds // d_mesh
    m0 = mesh.axis_index("model") * per_m           # first tile's shard
    parts, counts = [], []
    with R.shard_local():       # the tiles are this rank's own values
        for db in range(per_d):
            x_t = x[db * bt:(db + 1) * bt]
            a_t = a[db * bt:(db + 1) * bt]
            x_signs = kops.sign_pack(x_t) if strategy != "pallas" else None
            tiles = []
            for t, (sign_l, params_l) in enumerate(slices):
                y_s, c_s = _local_mlp(sign_l, params_l, x_t, cfg, a_t,
                                      strategy, cap_l,
                                      caps[m0 + t] if clamp else None,
                                      return_stats, x_signs)
                tiles.append(_pack_partial(y_s, c_s) if return_stats
                             else y_s)
                if return_stats:
                    counts.append(_count_matrix_one(c_s))
            parts.append(torch.stack(tiles, dim=0))   # (per_m, bt, d[+2])
    local = torch.stack(parts, dim=1)          # (per_m, per_d, bt, d[+2])
    n_c = len(COUNT_COLS)
    if return_stats:
        # each tile's count matrix rides with its partial, so one gather
        # over the line carries both
        cm = torch.stack(counts).reshape(per_d, per_m, bt, n_c)
        local = torch.cat([local, cm.transpose(0, 1)], dim=-1)
    if m_mesh > 1:
        local = _gather_rows(local, mesh, "model")
    if return_stats:
        # (per_d, bt, n): each block's counts summed over every tile of
        # the line (integer-valued float32: exact in any order)
        cm = local[..., -n_c:].sum(0)
        local = local[..., :-n_c]
    rows = []
    for j in range(per_d):
        if not return_stats:
            rows.append(_combine_gathered(local[:, j], False, k // ms))
            continue
        y_t, real_t, union_t = _combine_gathered(local[:, j], True, k // ms)
        rows.append((y_t, real_t, union_t))
    if not return_stats:
        return torch.cat(rows, dim=0)
    y, shard_real, shard_union = (torch.cat([r[i] for r in rows], dim=0)
                                  for i in range(3))
    totals_mat = cm.reshape(per_d * bt, n_c)
    totals = {col: totals_mat[:, i] for i, col in enumerate(COUNT_COLS)}
    return y, _finalize_stats(totals, shard_real, shard_union, k,
                              cfg.tp_shards)


def dense_apply(params: dict, x: torch.Tensor, cfg: SM.SparseInferConfig,
                return_stats: bool = False):
    """The dense MLP of a tensor-sharded config: each model shard's
    partial on its rows (``core.sparse_mlp.dense_parts``) with its count
    of active rows, summed over the shards in ascending order in float32
    (the counts exactly).  On one device a loop over the shards' row
    views; under a current mesh split over 'model' each rank runs its
    shards on the rows it holds, for the token rows it is given (a
    replicated prefill's, or its 'data' line's slots: nothing crosses
    'data'), and gathers the partials over its 'model' line,
    so every placement of the grid gets the same bits.  Returns y float32
    [and the ``MLP_STAT_KEYS`` of ``dense_mlp``]."""
    _, ms = semantic_grid(cfg)
    mesh = R.current_mesh()
    m_mesh, _ = _mesh_sizes(cfg, mesh)
    per_m = ms // m_mesh
    k = Q.mlp_hidden_rows(params) * m_mesh
    parts = []
    for s in range(per_m):
        y_s, g1 = SM.dense_parts(_slice_rows(params, s, per_m), x, cfg)
        active = (g1 > 0).sum(-1, dtype=torch.float32)
        parts.append(torch.cat([y_s.float(), active[..., None]], dim=-1))
    packed = torch.stack(parts)                    # (per_m, ..., d + 1)
    if m_mesh > 1:
        packed = _gather_rows(packed, mesh, "model")
    total = packed[0]
    for s in range(1, ms):
        total = total + packed[s]
    y = total[..., :-1]
    if not return_stats:
        return y
    kf = torch.tensor(float(k), device=x.device)
    return y, SM._stats(y.shape[:-1], x.device, predicted_density=1.0,
                        realized_density=1.0,
                        actual_density=total[..., -1] / kf,
                        union_demand_frac=1.0)


def selection_masks(params: dict, x: torch.Tensor,
                    cfg: SM.SparseInferConfig, alpha, *,
                    strategy: str = "gather") -> torch.Tensor:
    """(ds, k/G) bool: the row groups each data block's shard-local union
    selections keep, the ms shards' masks side by side.  The margins and
    selections are ``_local_mlp``'s for gather (pallas's predictor gives
    the same margins)."""
    if strategy not in ("gather", "pallas"):
        raise ValueError(
            "selection_masks is defined for the capacity-selected union "
            f"strategies, got {strategy!r}")
    ds, ms, k, caps, cap_l, clamp, slices, bt, a = _grid_inputs(
        params, x, cfg, alpha)
    g = cfg.group_size
    rows = []
    for db in range(ds):
        x_t = x[db * bt:(db + 1) * bt]
        x_signs = kops.sign_pack(x_t)
        per_shard = []
        for s, (sign_l, _) in enumerate(slices):
            m_tok = kops.predict_margins(sign_l, x_signs, x.shape[-1],
                                         a[db * bt:(db + 1) * bt])
            gm = S.union_margin(S.group_margins(m_tok, g))
            sel, sstats = S.capacity_select_with_stats(gm, cap_l)
            if clamp:
                sel, sstats = S.clamp_selection(sel, sstats, caps[s])
            per_shard.append(S.mask_from_selection(sel, (k // g) // ms))
        rows.append(torch.cat(per_shard))
    return torch.stack(rows, dim=0)


def shard_gauge_rows(density_ema, union_ema=None):
    """Per-(layer, shard) gauge rows for the metrics hub: ``(layer, shard,
    density, union)`` from the (L, ms) shard EMAs that
    ``runtime.controller.DistributedController`` keeps (union None when no
    union EMA is given).  Host numpy only."""
    d = np.asarray(density_ema, np.float32)
    u = None if union_ema is None else np.asarray(union_ema, np.float32)
    for layer in range(d.shape[0]):
        for shard in range(d.shape[1]):
            yield (layer, shard, float(d[layer, shard]),
                   None if u is None else float(u[layer, shard]))


def sharded_apply(params: dict, x: torch.Tensor, cfg: SM.SparseInferConfig,
                  alpha, *, strategy: str, return_stats: bool = False):
    """The sharded strategies' entry (from ``core.sparse_mlp.apply``): x is
    (d,) or (B, d); the grouped (G, B, d) layout of the unsharded gather
    does not compose with a shard grid.  Under a current mesh of more than
    one rank ``shard_map_apply`` runs the grid, else ``emulated_apply``."""
    squeeze = x.ndim == 1
    xb = x[None] if squeeze else x
    if xb.ndim != 2:
        raise ValueError(
            f"tp_shards decode expects (B, d) tokens, got {tuple(x.shape)}: "
            "the grouped (G, B, d) gather layout does not compose with a "
            "shard grid")
    mesh = R.current_mesh()
    if _mesh_sizes(cfg, mesh) != (1, 1):
        out = shard_map_apply(params, xb, cfg, alpha, mesh=mesh,
                              strategy=strategy, return_stats=return_stats)
    else:
        out = emulated_apply(params, xb, cfg, alpha, strategy=strategy,
                             return_stats=return_stats)
    if not squeeze:
        return out
    if return_stats:
        y, stats = out
        return y[0], {kk: v[0] for kk, v in stats.items()}
    return out[0]
