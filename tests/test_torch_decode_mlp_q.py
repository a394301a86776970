"""The int8 decode MLP (``csrc/fused_sparse_mlp_q.cu``) off the card: its
summation order and its host plan.

- A plain-torch emulation of the kernel's order: gate/up per row, each
  thread's 16-column piece (one column when qg is not a multiple of 16)
  summed, the pieces of a quant slab added in the kernel's lane butterfly
  (a pairwise tree over 2^i lanes, then the slab's remaining items in
  order, carried across the end of a 4096-column round), each slab's
  partial times its row's scale added with one rounding (the kernel's
  fmaf) in ascending q.  h float32.  Down per (512-column tile, group)
  unit: the group's products, times its scale row, added with one
  rounding in selection order within each block's run of units; the runs
  added in block order.  Exact products are summed in float64 and rounded
  to float32 once per piece or group here; the card sums them in float32
  instead.  Held against the reference's Pallas ``fused_sparse_mlp_q`` in
  interpret mode within rtol=atol=1e-5 (the port's TOL), over bf16 and
  float32 x, B in {1, ..., 16}, gated and ungated, fatrelu, G in {1, 8,
  16}, qg in {G, 32, 128} and layouts of both gate/up modes, a short count,
  d not a multiple of 128 and d above one round of 4096 columns (slabs cut
  by the round's end).
- The plan: gate/up's rows and down's units cover every selected row and
  (tile, group) once, in equal contiguous ranges a block; each block's run
  in a tile has its own slot; the shared memory fits, also at d=8192 for
  every quant width; the grid is resident for the occupancy it is given;
  no block is idle at the main shape, full and a third of the selection;
  it raises past its limits.
- The launcher refuses CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictor as JP
from repro.core import quantize as JQ
from repro.core import selection as JS
from repro.kernels import ops as jops
from repro_torch.kernels import sparse_mlp_fused as KF
from test_torch_chunk_mlp_tc import SMS, TOL

QNAMES = ("wg_q", "wg_s", "wu_q", "wu_s", "wd_q", "wd_s")


def H100(nb: int, mode: int, smem: int) -> int:
    """decode_q_plan's occupancy for an H100 off the card: blocks per SM
    limited by threads (2048), registers (at most 128 a thread: 2 blocks)
    and shared memory (228 KB, 1 KB reserved per block)."""
    return min(2048 // KF.Q_THREADS, 2, 233472 // (smem + 1024 + 1024))


# ------------------------------------------------- the kernel's order --

def _fma(p, s, acc):
    """acc + p s rounded once to float32, as the kernel's fmaf."""
    return (acc.double() + p.double() * s.double()).float()


def _tree(v: torch.Tensor) -> torch.Tensor:
    """The xor butterfly's sum over the last axis (a power of two), float32:
    ((v0 + v1) + (v2 + v3)) + ..."""
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def _gate_up(xf, w, s, qg):
    """The kernel's gate (or up) value of rows w (R, d) int8 with scales s
    (R, d/qg), x (B, d) float32 -> (R, B) float32."""
    r, d = w.shape
    nq = d // qg
    prod = w.double()[:, None, :] * xf.double()[None]            # exact
    if KF.q_mode(qg) == KF.Q_SLAB16:
        pieces = prod.reshape(r, -1, d // KF.Q_PIECE, KF.Q_PIECE).sum(-1)
        pieces = pieces.float()
    else:
        pieces = prod.float()                      # one column a piece
    items = _tree(pieces.reshape(r, pieces.shape[1], -1, KF.q_lanes(qg)))
    items = items.reshape(r, -1, nq, items.shape[-1] // nq)
    slab = items[..., 0]
    for j in range(1, items.shape[-1]):
        slab = slab + items[..., j]
    acc = torch.zeros(slab.shape[:2])
    for q in range(nq):
        acc = _fma(slab[..., q], s[:, None, q], acc)
    return acc


def emulate_decode_q(x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, sel, count, *,
                     group_size, act_kind, thr, pl):
    """y of the int8 decode kernel for plan ``pl``, on the CPU."""
    b, d = x.shape
    g = group_size
    qg = d // wg_s.shape[1]
    rows = (sel[:count].long()[:, None] * g
            + torch.arange(g)[None, :]).reshape(-1)
    xf = x.float()
    gate = _gate_up(xf, wg_q[rows], wg_s[rows], qg)               # (R, B)
    ga = torch.relu(gate) if act_kind == 0 else torch.where(
        gate > thr, gate, torch.zeros(()))
    h = ga * _gate_up(xf, wu_q[rows], wu_s[rows], qg) if wu_q is not None \
        else ga
    # down: units (tile, group) tile-major in equal ranges a block; a
    # block's run in a tile chains its groups, the runs in block order
    n_units = pl.tiles * count
    y = torch.zeros((b, d))
    for ct in range(pl.tiles):
        c0, c1 = ct * KF.Q_TILE, min(d, (ct + 1) * KF.Q_TILE)
        if not count:
            continue
        first = KF.q_owner(ct * count, n_units, pl.grid)
        last = KF.q_owner((ct + 1) * count - 1, n_units, pl.grid)
        for blk in range(first, last + 1):
            u0, u1 = KF.q_range(n_units, pl.grid, blk)
            if u0 == u1:         # a block with no unit has no run
                continue
            acc = torch.zeros((b, c1 - c0))
            for u in range(max(u0, ct * count), min(u1, (ct + 1) * count)):
                j = u - ct * count
                r = rows[j * g:(j + 1) * g]
                prt = (h[j * g:(j + 1) * g].T.double()
                       @ wd_q[r, c0:c1].double()).float()
                acc = _fma(prt, wd_s[int(sel[j]) * g // qg, c0:c1], acc)
            y[:, c0:c1] = y[:, c0:c1] + acc
    return y


def _quantized(seed, b, d, k, g, qg, gated):
    rng = np.random.default_rng(seed)
    w = {n: (rng.standard_normal((k, d)) * d ** -0.5).astype(np.float32)
         for n in ("wg_t", "wu_t", "wd_t")}
    if not gated:
        w["wu_t"] = None
    x = rng.standard_normal((b, d)).astype(np.float32)
    qn = JQ.quantize_mlp_node({n: jnp.asarray(v) if v is not None else None
                               for n, v in w.items()}, qg, g)
    q = {n: np.array(qn[n]) if n in qn else None for n in QNAMES}
    pw = JP.pack_signs(jnp.asarray(w["wg_t"]))
    gm, _ = jops.predict_group_margins(
        pw, jnp.asarray(x), d, jnp.full((b,), 1.0, jnp.float32),
        group_size=g, interpret=True)
    cap = max(1, k // g // 4)
    sel, _ = JS.capacity_select_with_stats(JS.union_margin(gm), cap)
    return q, x, np.array(sel.indices), int(sel.count)


# name: (seed, B, d, k, G, qg, gated, activation, threshold, short count)
CASES = {
    "B=4 gated relu G=8 qg=128": (2, 4, 256, 512, 8, 128, True, "relu",
                                  0.0, False),
    "B=1 gated relu G=8 qg=32": (3, 1, 256, 512, 8, 32, True, "relu", 0.0,
                                 False),
    "B=16 gated relu G=8 qg=128 short count": (4, 16, 256, 512, 8, 128,
                                               True, "relu", 0.0, True),
    "B=4 ungated relu G=1 qg=1": (5, 4, 64, 256, 1, 1, False, "relu", 0.0,
                                  False),
    "B=3 gated relu G=1 qg=32": (6, 3, 128, 256, 1, 32, True, "relu", 0.0,
                                 False),
    "B=5 gated fatrelu G=16 qg=16": (7, 5, 192, 768, 16, 16, True,
                                     "fatrelu", 0.05, False),
    "B=12 gated fatrelu G=16 qg=32 d=96": (8, 12, 96, 512, 16, 32, True,
                                           "fatrelu", 0.0, False),
    "B=2 ungated relu G=8 qg=64 d=320": (9, 2, 320, 512, 8, 64, False,
                                         "relu", 0.0, False),
    "B=3 gated relu G=1 qg=4 d=100": (10, 3, 100, 500, 1, 4, True, "relu",
                                      0.0, False),
    "B=2 gated relu G=1 qg=6 (one column a thread)": (11, 2, 192, 576, 1, 6,
                                                      True, "relu", 0.0,
                                                      False),
    "B=4 gated relu G=8 qg=8": (12, 4, 128, 256, 8, 8, True, "relu", 0.0,
                                False),
    "B=8 gated relu G=16 qg=128 d=640 (two tiles)": (13, 8, 640, 512, 16,
                                                     128, True, "relu", 0.0,
                                                     False),
    "B=4 gated relu G=16 qg=48 (three pieces a slab)": (14, 4, 192, 576, 16,
                                                        48, True, "relu",
                                                        0.0, False),
    "B=6 gated relu G=8 qg=256": (15, 6, 512, 512, 8, 256, True, "relu",
                                  0.0, False),
    "B=3 gated relu G=8 qg=40 d=4120 (two rounds, a slab cut)": (
        16, 3, 4120, 320, 8, 40, True, "relu", 0.0, False),
    "B=5 gated fatrelu G=16 qg=48 d=4224 (two rounds, a slab cut)": (
        17, 5, 4224, 768, 16, 48, True, "fatrelu", 0.05, False),
    "B=9 ungated relu G=8 qg=128 d=8192 (two rounds)": (
        18, 9, 8192, 256, 8, 128, False, "relu", 0.0, False),
}


@pytest.mark.parametrize("xname", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_q_order_matches_reference_kernel(case, xname):
    seed, b, d, k, g, qg, gated, act, thr, short = CASES[case]
    q, x, sel, count = _quantized(seed, b, d, k, g, qg, gated)
    if short:
        count //= 3
    bf16 = xname == "bfloat16"
    xj = jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)
    y_ref = np.asarray(jops.fused_sparse_mlp_q(
        xj, *[jnp.asarray(q[n]) if q[n] is not None else None
              for n in QNAMES],
        jnp.asarray(sel), jnp.asarray(count, jnp.int32), group_size=g,
        activation=act, fatrelu_threshold=thr, interpret=True))
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
    tq = {n: torch.from_numpy(v) if v is not None else None
          for n, v in q.items()}
    pl = KF.decode_q_plan(b, d, len(sel) * g, g, qg, SMS, H100)
    act_kind = 1 if (act == "fatrelu" or thr > 0) else 0
    y = emulate_decode_q(xt, *[tq[n] for n in QNAMES],
                         torch.from_numpy(sel), count, group_size=g,
                         act_kind=act_kind, thr=thr, pl=pl).numpy()
    err = np.abs(y - y_ref)
    assert (err <= TOL["atol"] + TOL["rtol"] * np.abs(y_ref)).all(), \
        f"{case} x={xname}: max |y - y_ref| {err.max():.3e}"


# -------------------------------------------------------------- the plan --

@pytest.mark.parametrize("qg,mode,lanes,items", [
    (128, KF.Q_SLAB16, 8, 32), (64, KF.Q_SLAB16, 4, 64),
    (32, KF.Q_SLAB16, 2, 128), (16, KF.Q_SLAB16, 1, 256),
    (48, KF.Q_SLAB16, 1, 256), (8, KF.Q_SLAB1, 8, 512),
    (2, KF.Q_SLAB1, 2, 2048), (1, KF.Q_SLAB1, 1, 4096),
    (6, KF.Q_SLAB1, 2, 2048), (12, KF.Q_SLAB1, 4, 1024)])
def test_gate_up_layout_of_quant_width(qg, mode, lanes, items):
    """Each item lies inside one quant slab, a slab's items are whole lane
    groups, and a round's items cover its 4096 columns exactly."""
    d = 4096
    assert (KF.q_mode(qg), KF.q_lanes(qg)) == (mode, lanes)
    assert KF.q_items(d, qg) == items
    width = KF.Q_PIECE if mode == KF.Q_SLAB16 else 1  # columns of a piece
    assert qg % (width * lanes) == 0                  # items inside a slab
    assert items * width * lanes == KF.Q_ROUND_COLS
    assert 32 % lanes == 0


def test_plan_main_shape():
    """B=4 at d=4096 over 288 groups of 8 rows, qg=128: one pass of 4
    tokens, 6 stages of a row of Wg and of Wu and its 32 + 32 scales; a
    chain row of the carried sums, 32 slab partials and 64 scales; 18 rows
    a chain batch; 2 blocks a SM (264); 8 tiles of 512 columns for down.
    B=16: the same layout in 4 passes, down's stages larger."""
    pl = KF.decode_q_plan(4, 4096, 2304, 8, 128, SMS, H100)
    assert (pl.nb, pl.passes, pl.mode, pl.lanes, pl.items) == \
        (4, 1, KF.Q_SLAB16, 8, 32)
    assert pl.slab_scales == 32 and pl.stage_bytes == 8192 + 256
    assert pl.down_stage_bytes == 8 * 512 + 8 * 4 * 4 + 512 * 4
    assert pl.stages == KF.Q_STAGES and pl.chain_rows == 18
    assert pl.ring == KF.Q_STAGES * (8192 + 256)
    assert pl.row_floats == KF.Q_STATE + 32 * 8 + 64
    assert pl.smem_bytes == pl.ring + 18 * pl.row_floats * 4
    assert (pl.grid, pl.tiles) == (264, 8)
    assert pl.h_floats == 2304 * 4 and pl.part_floats == 272 * 4 * 512
    p16 = KF.decode_q_plan(16, 4096, 2304, 8, 128, SMS, H100)
    assert (p16.nb, p16.passes, p16.mode, p16.ring, p16.grid) == \
        (16, 4, KF.Q_SLAB16, pl.ring, 264)
    assert p16.down_stage_bytes == 8 * 512 + 8 * 16 * 4 + 512 * 4


@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("d,qg,g", [
    (8192, 1, 1), (8192, 2, 2), (8208, 6, 2), (8192, 8, 8), (8208, 48, 16),
    (8192, 64, 8), (8192, 128, 8)])
def test_plan_wide_d_fits(b, d, qg, g):
    """At d=8192 (8208 where qg has a factor 3; two or three rounds of 4096
    columns) every quant width plans: a chain row holds one round's items
    (and for 16-column pieces the round's scales, the slabs a round
    touches), at least one row a batch, so the shared memory stays under
    the limit however wide d is; the grid stays resident."""
    pl = KF.decode_q_plan(b, d, 2304, g, qg, SMS, H100)
    width = KF.Q_PIECE if pl.mode == KF.Q_SLAB16 else 1
    assert pl.items * width * pl.lanes == KF.Q_ROUND_COLS
    if pl.mode == KF.Q_SLAB16:
        touched = max(len({c // qg for c in range(c0, c0 + KF.Q_ROUND_COLS)})
                      for c0 in range(0, d, KF.Q_ROUND_COLS))
        assert pl.slab_scales >= touched
    assert pl.row_floats >= KF.Q_STATE + pl.items * 2 * KF.Q_NBP \
        + 2 * pl.slab_scales
    assert pl.chain_rows >= 1 and pl.smem_bytes <= KF.SMEM_LIMIT
    assert pl.grid >= SMS and pl.passes * KF.Q_NBP >= b
    # one column a thread holds the most: a round's 4096 one-column items
    assert KF.decode_q_plan(b, 4 * d, 2304, 1, 1, SMS, H100).smem_bytes \
        <= KF.SMEM_LIMIT


@pytest.mark.parametrize("b,d,cap_rows,g,qg", [
    (4, 4096, 2304, 8, 128), (16, 4096, 2304, 8, 128), (3, 100, 125, 1, 4),
    (12, 96, 128, 16, 32), (5, 640, 128, 16, 128), (2, 192, 144, 1, 6),
    (1, 8192, 512, 8, 64)])
def test_plan_covers_rows_and_units_once(b, d, cap_rows, g, qg):
    """For every count (every 8th for the large capacities): gate/up's
    block ranges partition the selected rows in order; down's units
    (tile, group) are covered once, a block's run in a tile is held by the
    blocks q_owner finds for the tile's first and last unit, and the runs'
    slots (block + tile) are distinct and within part_floats."""
    pl = KF.decode_q_plan(b, d, cap_rows, g, qg, SMS, H100)
    assert pl.tiles == -(-d // KF.Q_TILE)
    n_sel = cap_rows // g
    for count in range(0, n_sel + 1, 1 if n_sel <= 64 else 8):
        nrows = count * g
        spans = [KF.q_range(nrows, pl.grid, i) for i in range(pl.grid)]
        assert spans[0][0] == 0 and spans[-1][1] == nrows
        assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
        n_units = pl.tiles * count
        cover = np.zeros((pl.tiles, count), np.int32)
        slots = set()
        for i in range(pl.grid):
            u0, u1 = KF.q_range(n_units, pl.grid, i)
            for u in range(u0, u1):
                ct, j = divmod(u, count)
                cover[ct, j] += 1
                assert KF.q_owner(u, n_units, pl.grid) == i
                slots.add((i + ct, i))
        assert (cover == 1).all()
        assert len({s for s, _ in slots}) == len(slots)
        assert all(s < pl.part_floats // (pl.nb * KF.Q_TILE)
                   for s, _ in slots)
        assert nrows * pl.nb <= pl.h_floats


@pytest.mark.parametrize("count", [288, 96])
def test_plan_no_idle_block_at_main_shape(count):
    """At the main shape every block has 8-9 (a third: 2-3) rows of
    gate/up and 8-9 (2-3) down units: max over mean within 1.04."""
    pl = KF.decode_q_plan(4, 4096, 2304, 8, 128, SMS, H100)
    rows = [np.subtract(*KF.q_range(count * 8, pl.grid, i)[::-1])
            for i in range(pl.grid)]
    units = [np.subtract(*KF.q_range(pl.tiles * count, pl.grid, i)[::-1])
             for i in range(pl.grid)]
    for n in (rows, units):
        assert min(n) >= 1 and max(n) - min(n) <= 1
        assert max(n) / np.mean(n) < 1.04


@pytest.mark.parametrize("occ", [1, 2, 3, 8])
def test_plan_grid_resident_and_smem_fits(occ):
    for b in (1, 4, 9, 16):
        for d, g, qg in ((4096, 8, 128), (100, 1, 4), (192, 1, 6),
                         (8192, 1, 1)):
            pl = KF.decode_q_plan(b, d, 64 * g, g, qg, SMS,
                                  lambda nb, mode, smem: occ)
            assert pl.grid == min(occ, KF.MAX_BLOCKS_PER_SM) * SMS
            assert pl.smem_bytes == pl.ring \
                + pl.chain_rows * pl.row_floats * 4
            assert pl.ring == pl.stages * max(pl.stage_bytes,
                                              pl.down_stage_bytes)
            assert pl.row_floats >= KF.Q_STATE + pl.items * 2 * KF.Q_NBP
            assert pl.passes * KF.Q_NBP >= b
            assert pl.smem_bytes <= KF.SMEM_LIMIT and pl.nb >= b


def test_plan_raises_past_its_limits():
    with pytest.raises(RuntimeError, match="fused_sparse_mlp_q: .*"
                       "cannot be scheduled"):
        KF.decode_q_plan(4, 4096, 2304, 8, 128, SMS, lambda *a: 0)
    with pytest.raises(ValueError, match="bad shape"):
        KF.decode_q_plan(17, 4096, 2304, 8, 128, SMS, H100)
    with pytest.raises(ValueError, match="bad shape"):
        KF.decode_q_plan(4, 4098, 2304, 8, 2, SMS, H100)
    with pytest.raises(ValueError, match="bad shape"):
        KF.decode_q_plan(4, 4096, 2304, 8, 4, SMS, H100)
    with pytest.raises(ValueError, match="bad shape"):
        KF.decode_q_plan(4, 4096, 2300, 8, 128, SMS, H100)
    # one column a thread at a wide d is no limit: a chain row holds one
    # round of 4096 columns
    assert KF.decode_q_plan(4, 6 * 4096, 2304, 2, 6, SMS,
                            H100).smem_bytes <= KF.SMEM_LIMIT


def test_decode_q_launcher_refuses_cpu_tensors():
    """The launcher takes CUDA tensors only: on the CPU the ops layer runs
    the plain version, and the launcher is never reached."""
    x = torch.zeros((4, 32))
    w = torch.zeros((64, 32), dtype=torch.int8)
    s_row = torch.ones((64, 1))
    s_col = torch.ones((2, 32))
    sel = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        KF.fused_sparse_mlp_q(x, w, s_row, w, s_row, w, s_col, sel,
                              torch.tensor(2), group_size=8)
