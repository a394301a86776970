"""The int8 chunk MLP on the tensor cores (``csrc/fused_sparse_mlp_chunk_q.cu``,
the int8 instantiation of ``csrc/fused_sparse_mlp_chunk_tc.cuh``) off the
card: its numeric recipe and its host plan.

- The int8 -> TF32 conversion the kernel does in registers (a byte permute
  and a subtract) gives every int8 value exactly, with the 13 low mantissa
  bits zero (what the MMA reads).
- A plain-torch emulation of the kernel: int8 weights exact in bf16 and
  TF32, bf16 x unsplit (one bf16 MMA) and float32 x split in two TF32
  parts, h float32 split in two;
  gate/up summed per quant slab piece (a slab cut at the plan's 128-column
  chunks), each piece's sum times its row's scale added to the float32 sum
  with one rounding (the kernel's fmaf) in the chunk order of the plan's
  splits of d, the splits added in split order; down summed per selection
  group, times the group's scale row and added the same way in selection
  order within the plan's slices (starting on multiples of lcm(8, G)), the
  slices added in slice order.  Exact TF32 products are
  summed in float64 and rounded to float32 once per piece or group here;
  the card's MMA truncates within them instead.  Held against the
  reference's Pallas ``fused_sparse_mlp_chunk_q`` in interpret mode within
  rtol=atol=1e-5 (the port's TOL: float32 sums of the same products in
  another order), over bf16 and float32 x, gated and ungated, fatrelu, G in
  {1, 8, 16}, qg in {G, 32, 128} and slabs wider than a chunk, a short
  count and d not a multiple of 128.
- The same emulation with h rounded to TF32 once (no split) is ~1e-4 off
  and fails that check, so the check tells the two apart.
- The int8 plan: items cover every selected row and column once, down's
  slices hold whole selection groups, the shared memory fits, the grid is
  resident for the occupancy it is given, and it raises past its limits.
- The launcher refuses CPU tensors.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictor as JP
from repro.core import quantize as JQ
from repro.core import selection as JS
from repro.kernels import ops as jops
from repro_torch.kernels import sparse_mlp_fused as KF
from test_torch_chunk_mlp_tc import H100, SMS, TOL, tf32_rna, tf32_split

QNAMES = ("wg_q", "wg_s", "wu_q", "wu_s", "wd_q", "wd_s")


# --------------------------------------------------- int8 in the MMA --

def test_int8_to_tf32_conversion_is_exact():
    """fused_sparse_mlp_chunk_tc.cuh:i8_tf32: the byte xor 0x80 placed in
    the mantissa of 2^23 (0x4B0000uu), minus 2^23 + 128, is the int8 value,
    and its low 13 bits are zero."""
    b = np.arange(256, dtype=np.uint32)
    bits = (0x4B000000 | (b ^ 0x80)).astype(np.uint32)
    f = bits.view(np.float32) - np.float32(8388736.0)
    want = b.astype(np.uint8).view(np.int8).astype(np.float32)
    np.testing.assert_array_equal(f, want)
    assert not (f.view(np.uint32) & 0x1FFF).any()
    assert not (tf32_rna(torch.from_numpy(want)) - torch.from_numpy(want)
                ).any()


# ------------------------------------------------- the kernel's recipe --

def _x_parts(x: torch.Tensor):
    """The TF32 parts of x the kernel multiplies: bf16 x itself, float32 x
    big and small."""
    xf = x.float()
    if x.dtype == torch.bfloat16:
        return [xf]
    return list(tf32_split(xf))


def _fma(p, s, acc):
    """acc + p s rounded once to float32, as the kernel's fmaf (p s is exact
    in float64; the sum's double rounding does not matter at TOL)."""
    return (acc.double() + p.double() * s.double()).float()


def emulate_chunk_q(x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, sel, count, *,
                    group_size, act_kind, thr, pl, h_one_pass=False):
    """y of the int8 tensor-core chunk kernel for plan ``pl``, on the CPU."""
    s, d = x.shape
    g = group_size
    qg = d // wg_s.shape[1]
    nrows = count * g
    rows = (sel[:count].long()[:, None] * g
            + torch.arange(g)[None, :]).reshape(-1)
    xt = sum(p.double() for p in _x_parts(x)).T          # (d, S), exact
    # ---- gate/up: 64-row tiles, d cut into the plan's splits of chunks;
    # per chunk its slab pieces in column order, each scaled, then added
    rt = -(-nrows // KF.ROWS)
    nks = min(KF.splits(pl.grid, rt, pl.max_splits), pl.k_chunks)
    outs = []
    for w, sc in ((wg_q, wg_s), (wu_q, wu_s)):
        if w is None:
            outs.append(None)
            continue
        wr = w[rows].double()                             # exact int8
        sr = sc[rows]                                     # (M, nq)
        total = torch.zeros((nrows, s))
        for ks in range(nks):
            acc = torch.zeros((nrows, s))
            for c in KF.split_chunks(ks, pl.k_chunks, nks):
                c0, c1 = c * pl.chunk_cols, min((c + 1) * pl.chunk_cols, d)
                lo = c0
                while lo < c1:
                    q = lo // qg
                    hi = min((q + 1) * qg, c1)
                    p = (wr[:, lo:hi] @ xt[lo:hi]).float()
                    acc = _fma(p, sr[:, q:q + 1], acc)
                    lo = hi
            total = total + acc                           # split order
        outs.append(total)
    gsum, usum = outs
    ga = torch.relu(gsum) if act_kind == 0 else torch.where(
        gsum > thr, gsum, torch.zeros(()))
    h = ga * usum if usum is not None else ga             # float32
    hp = tf32_rna(h).double() if h_one_pass else \
        sum(p.double() for p in tf32_split(h))
    # ---- down: the plan's slices of whole groups, in slice order; per
    # group its products, times the group's scale row, in selection order
    nsl = KF.slices(pl.grid, pl.col_tiles, nrows)
    wdr = wd_q[rows].double()                             # (rows, d)
    srow = wd_s[rows // qg]                               # (rows, d)
    y = torch.zeros((d, s))
    for sl in range(nsl):
        r0, r1 = KF.slice_range(sl, nrows, nsl, pl.slice_unit)
        acc = torch.zeros((d, s))
        for g0 in range(r0, r1, g):
            p = (wdr[g0:g0 + g].T @ hp[g0:g0 + g]).float()   # (d, S)
            acc = _fma(p, srow[g0][:, None], acc)
        y = y + acc
    return y.T.contiguous()


def _quantized(seed, s, d, k, g, qg, gated):
    rng = np.random.default_rng(seed)
    w = {n: (rng.standard_normal((k, d)) * d ** -0.5).astype(np.float32)
         for n in ("wg_t", "wu_t", "wd_t")}
    if not gated:
        w["wu_t"] = None
    x = rng.standard_normal((s, d)).astype(np.float32)
    qn = JQ.quantize_mlp_node({n: jnp.asarray(v) if v is not None else None
                               for n, v in w.items()}, qg, g)
    q = {n: np.array(qn[n]) if n in qn else None for n in QNAMES}
    pw = JP.pack_signs(jnp.asarray(w["wg_t"]))
    gm, _ = jops.predict_chunk_group_margins(
        pw, jnp.asarray(x), d, jnp.full((s,), 1.0, jnp.float32),
        group_size=g, interpret=True)
    cap = max(1, k // g // 4)
    sel, _ = JS.capacity_select_with_stats(JS.union_margin(gm), cap)
    return q, x, np.array(sel.indices), int(sel.count)


# name: (seed, S, d, k, G, qg, gated, activation, threshold, short count)
CASES = {
    "gated relu G=8 qg=128": (2, 20, 256, 512, 8, 128, True, "relu", 0.0,
                              False),
    "gated relu G=8 qg=32 short count": (3, 20, 256, 512, 8, 32, True,
                                         "relu", 0.0, True),
    "gated relu G=8 qg=8": (4, 9, 128, 256, 8, 8, True, "relu", 0.0, False),
    "gated relu G=8 qg=256 (slabs cut by chunks)": (5, 12, 512, 512, 8, 256,
                                                    True, "relu", 0.0, False),
    "ungated relu G=1 qg=1": (6, 5, 64, 256, 1, 1, False, "relu", 0.0,
                              False),
    "gated relu G=1 qg=32": (7, 7, 128, 256, 1, 32, True, "relu", 0.0,
                             False),
    "gated fatrelu G=16 qg=16": (8, 37, 192, 768, 16, 16, True, "fatrelu",
                                 0.05, False),
    "gated fatrelu G=16 qg=32 d=96": (9, 12, 96, 512, 16, 32, True,
                                      "fatrelu", 0.0, False),
    "ungated relu G=8 qg=64 d=320": (10, 17, 320, 512, 8, 64, False, "relu",
                                     0.0, False),
    "gated relu G=1 qg=4 d=100": (11, 3, 100, 500, 1, 4, True, "relu", 0.0,
                                  False),
}


def _check(case, xname, h_one_pass):
    seed, s, d, k, g, qg, gated, act, thr, short = CASES[case]
    q, x, sel, count = _quantized(seed, s, d, k, g, qg, gated)
    if short:
        count //= 3
    bf16 = xname == "bfloat16"
    xj = jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)
    y_ref = np.asarray(jops.fused_sparse_mlp_chunk_q(
        xj, *[jnp.asarray(q[n]) if q[n] is not None else None
              for n in QNAMES],
        jnp.asarray(sel), jnp.asarray(count, jnp.int32), group_size=g,
        activation=act, fatrelu_threshold=thr, interpret=True))
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
    tq = {n: torch.from_numpy(v) if v is not None else None
          for n, v in q.items()}
    pl = KF.plan(s, d, len(sel) * g, 2 if bf16 else 4, SMS, H100, 1, g)
    act_kind = 1 if (act == "fatrelu" or thr > 0) else 0
    y = emulate_chunk_q(xt, *[tq[n] for n in QNAMES], torch.from_numpy(sel),
                        count, group_size=g, act_kind=act_kind, thr=thr,
                        pl=pl, h_one_pass=h_one_pass).numpy()
    err = np.abs(y - y_ref)
    return bool((err <= TOL["atol"] + TOL["rtol"] * np.abs(y_ref)).all()), \
        float(err.max()), float(np.abs(y_ref).max())


@pytest.mark.parametrize("xname", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_int8_recipe_matches_reference_kernel(case, xname):
    ok, err, _ = _check(case, xname, h_one_pass=False)
    assert ok, f"{case} x={xname}: max |y - y_ref| {err:.3e}"


@pytest.mark.parametrize("xname", ["float32", "bfloat16"])
def test_h_in_one_tf32_pass_fails_the_same_check(xname):
    """h rounded to TF32 once (one MMA against Wd, no split) is ~1e-4 of
    max|y| off: a different function, which the check above refuses."""
    ok, err, scale = _check("gated relu G=8 qg=128", xname, h_one_pass=True)
    assert not ok and err > 1e-5 * scale, \
        f"one pass within tolerance: {err:.3e} of max|y| {scale:.3e}"


# ------------------------------------------------------- the int8 plan --

def test_plan_q_main_shape():
    """S=64 bf16 x at d=4096 over 288 groups of 8, int8 weights: one token
    tile of 64, 3 stages of 32.5 KB (gate/up's two 64 x 128-byte weight
    tiles, 64 x 128 bf16 of x and 2 x 64 scales, larger than down's) and the
    selection, so 2 blocks a SM (264);
    32 chunks of 128 columns cut 7 ways over 36 row tiles, 8 slices for the
    32 column tiles of down (4 stages of its own in the same ring); hT
    holds (big, small) pairs."""
    pl = KF.plan(64, 4096, 2304, 2, SMS, H100, 1, 8)
    assert (pl.nt, pl.token_tile, pl.s_pad, pl.grid) == (8, 64, 64, 264)
    assert (pl.k_chunks, pl.col_tiles, pl.chunk_cols) == (32, 32, 128)
    assert KF.splits(pl.grid, 36, pl.max_splits) == 7
    assert KF.slices(pl.grid, pl.col_tiles, 2304) == 8
    gu_stage = 2 * 64 * 128 + 64 * 128 * 2 + 2 * 64 * 4
    down_stage = 32 * 144 + 64 * 32 * 8 + 4 * 512
    assert gu_stage >= down_stage and 3 * gu_stage // down_stage == 4
    assert pl.smem_bytes == 3 * gu_stage + 288 * 4 == 100992
    assert pl.h_stride == 2304 and pl.h_floats == 2 * 64 * 2304
    assert pl.slice_unit == 8
    # float32 x: 48 KB stages, one block a SM
    pf = KF.plan(64, 4096, 2304, 4, SMS, H100, 1, 8)
    assert pf.smem_bytes == 3 * (2 * 64 * 128 + 64 * 128 * 4 + 512) + 1152
    assert pf.grid == SMS


@pytest.mark.parametrize("d,cap_rows,g", [(4096, 2304, 8), (100, 125, 1),
                                          (192, 192, 16), (96, 128, 16),
                                          (320, 128, 8), (128, 72, 3)])
def test_plan_q_items_cover_rows_and_columns_once(d, cap_rows, g):
    """For every count (every 8th for the large capacities) the int8
    kernel's gate/up items (64-row tile x split of the 128-column chunks of
    d) cover each selected row x each chunk exactly once; down's items
    (slice x 128-column tile) cover each row once, and each slice starts
    on a multiple of lcm(8, G) and holds whole selection groups."""
    pl = KF.plan(64, d, cap_rows, 2, SMS, H100, 1, g)
    assert pl.slice_unit == math.lcm(8, g)
    assert (pl.k_chunks - 1) * KF.KC_Q < d <= pl.k_chunks * KF.KC_Q
    n_sel = cap_rows // g
    for count in range(0, n_sel + 1, 1 if n_sel <= 64 else 8):
        nrows = count * g
        rt = -(-nrows // KF.ROWS)
        nks = min(KF.splits(pl.grid, rt, pl.max_splits), pl.k_chunks)
        cover = np.zeros((nrows, pl.k_chunks), np.int32)
        for item in range(rt * nks):
            r, ks = divmod(item, nks)
            cover[r * KF.ROWS:(r + 1) * KF.ROWS,
                  list(KF.split_chunks(ks, pl.k_chunks, nks))] += 1
        assert (cover == 1).all()
        assert 2 * rt * nks * KF.ROWS * pl.s_pad <= pl.gu_floats
        nsl = KF.slices(pl.grid, pl.col_tiles, nrows)
        cover = np.zeros((nrows, pl.col_tiles), np.int32)
        for item in range(nsl * pl.col_tiles):
            sl, ct = divmod(item, pl.col_tiles)
            r0, r1 = KF.slice_range(sl, nrows, nsl, pl.slice_unit)
            assert r1 > r0 and r0 % pl.slice_unit == 0
            assert r0 % g == 0 and r1 % g == 0      # whole groups
            cover[r0:r1, ct] += 1
        assert (cover == 1).all()
        assert nsl * 64 * d <= pl.part_floats


@pytest.mark.parametrize("x_elem", [2, 4])
@pytest.mark.parametrize("occ", [1, 2, 3, 8])
def test_plan_q_grid_resident_and_smem_fits(occ, x_elem):
    for s in (1, 9, 33, 64, 300):
        pl = KF.plan(s, 4096, 2304, x_elem, SMS, lambda nt, smem: occ, 1, 8)
        assert pl.grid == min(occ, KF.MAX_BLOCKS_PER_SM) * SMS
        assert pl.smem_bytes == KF.STAGES_Q * KF.stage_bytes(
            pl.nt, x_elem, 1) + KF.sel_bytes(2304 // 8)
        assert pl.smem_bytes <= KF.SMEM_LIMIT


def test_plan_q_raises_past_its_limits():
    with pytest.raises(RuntimeError, match="fused_sparse_mlp_chunk_q: .*"
                       "cannot be scheduled"):
        KF.plan(64, 4096, 2304, 2, SMS, lambda nt, smem: 0, 1, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        KF.plan(64, 4098, 2304, 2, SMS, H100, 1, 8)
    with pytest.raises(ValueError, match="bad shape"):
        KF.plan(64, 4096, 2304, 2, SMS, H100, 2, 8)
    with pytest.raises(ValueError, match="bad shape"):
        KF.plan(64, 4096, 2304, 2, SMS, H100, 1, 0)
    with pytest.raises(ValueError, match=f"limit of {KF.INT32_MAX}"):
        KF.plan(600_000, 4096, 2304, 2, SMS, H100, 1, 8)


def test_chunk_q_launcher_refuses_cpu_tensors():
    """The launcher takes CUDA tensors only: on the CPU the ops layer runs
    the plain version, and the launcher is never reached."""
    x = torch.zeros((4, 32))
    w = torch.zeros((64, 32), dtype=torch.int8)
    s_row = torch.ones((64, 1))
    s_col = torch.ones((2, 32))
    sel = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        KF.fused_sparse_mlp_chunk_q(x, w, s_row, w, s_row, w, s_col, sel,
                                    torch.tensor(2), group_size=8)
