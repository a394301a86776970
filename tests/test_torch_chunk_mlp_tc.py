"""The tensor-core chunk MLP (``csrc/fused_sparse_mlp_chunk_tc.cuh``) off the
card: its numeric recipe and its host plan.

- The split: every float32 v is big = rna_tf32(v) plus small =
  rna_tf32(v - big), each with its 13 low mantissa bits zero (what the MMA
  reads), and big + small is within 2^-22 |v| of v.
- A plain-torch emulation of the kernel: the split operands, exact TF32
  products summed per 32-deep stage and added to float32 sums in the
  kernel's order (gate/up over d in the plan's splits, added in split
  order; down over the selected rows in the plan's slices of 8-row units,
  added in slice order), against the reference's Pallas ``fused_sparse_mlp_chunk`` in
  interpret mode, within rtol=atol=1e-5 (the port's TOL: float32 sums of
  the same products in another order).  With bf16 x, h is rounded to
  bf16; where the exact h lies within 1e-5 of a bf16 rounding boundary the
  two sides may round it one bf16 ulp apart, and y may then differ by that
  ulp times the row of Wd beside the TOL (counted, and at most 2 such h in
  a case).
- The same emulation with each weight rounded to TF32 once, no split: ~1e-3
  relative error, it fails that check, so the check tells the two apart.
- The plan: tile sizes, the split of d and the slices cover every selected
  row and every column exactly once for every count, the shared memory
  fits, the grid is resident for the occupancy it is given, and it raises
  past its limits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictor as JP
from repro.core import selection as JS
from repro.kernels import ops as jops
from repro_torch.kernels import sparse_mlp_fused as KF

TOL = dict(rtol=1e-5, atol=1e-5)
SMS = 132


def H100(nt: int, smem: int) -> int:
    """plan's occupancy for an H100 off the card: blocks per SM limited by
    threads (2048) and shared memory (228 KB, 1 KB reserved per block)."""
    return min(2048 // KF.THREADS, 233472 // (smem + 1024 + 1024))


# ------------------------------------------------------------ the split --

def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 explicit mantissa bits, to nearest,
    ties away from zero (the low 13 bits become 0)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(v: torch.Tensor):
    big = tf32_rna(v)
    return big, tf32_rna(v - big)


def _low_bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32) & 0x1FFF


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_split_reconstructs_within_bound(scale):
    rng = np.random.default_rng(0)
    v = torch.from_numpy(
        (rng.standard_normal(100_000) * scale).astype(np.float32))
    v[:4] = torch.tensor([1.0, -1.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11)])
    big, small = tf32_split(v)
    assert not _low_bits(big).any() and not _low_bits(small).any()
    # v - big is exact in float32
    vd, bd, sd = v.double(), big.double(), small.double()
    assert torch.equal((v - big).double(), vd - bd)
    assert bool(((vd - bd - sd).abs() <= 2.0 ** -22 * vd.abs()).all())
    assert bool(((vd - bd).abs() <= 2.0 ** -11 * vd.abs()).all())
    # ties round away from zero, as cvt.rna does
    assert big[2] == 1.0 + 2 ** -10 and big[3] == -(1.0 + 2 ** -10)


def test_split_of_bf16_values_is_exact():
    """A bf16 value is exact in TF32: its small part is 0, which is why
    bf16 x (and h rounded to bf16) go into the MMA unsplit."""
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.standard_normal(10_000).astype(np.float32))
    v = v.to(torch.bfloat16).float()
    big, small = tf32_split(v)
    assert torch.equal(big, v) and not small.any()


# ------------------------------------------------- the kernel's recipe --

def _mma_stages(acc: torch.Tensor, passes, stages) -> torch.Tensor:
    """acc (M, N) float32 += a (M, K) b (K, N) as the kernel does it, over
    the K ranges ``stages`` in order (32 deep, the last of d short): in
    each stage the passes (pairs of split parts) of its 8-deep steps go
    into a zeroed MMA fragment (exact TF32 products, summed and rounded to
    float32 once here; the card's MMA truncates within the stage instead),
    which is then added to acc in float32."""
    for lo, hi in stages:
        stage = sum(pa[:, lo:hi].double() @ pb[lo:hi].double()
                    for pa, pb in passes)
        acc = acc + stage.float()
    return acc


def _passes(a: torch.Tensor, b: torch.Tensor, a_exact: bool,
            b_exact: bool, one_pass: bool):
    """The kernel's passes for a b: bf16 operands unsplit, the others
    big + small; a.b = abig.bbig + asmall.bbig + abig.bsmall.  With
    ``one_pass`` each float32 operand is rounded to TF32 once instead."""
    if one_pass:
        return [(a if a_exact else tf32_rna(a), b if b_exact else tf32_rna(b))]
    ab, as_ = (a, None) if a_exact else tf32_split(a)
    bb, bs = (b, None) if b_exact else tf32_split(b)
    out = [(ab, bb)]
    if as_ is not None:
        out.append((as_, bb))
    if bs is not None:
        out.append((ab, bs))
    return out


def emulate_chunk(x, wg, wu, wd, sel, count, *, group_size, act_kind, thr,
                  pl, one_pass=False):
    """y of the tensor-core chunk kernel for plan ``pl``, on the CPU."""
    s, d = x.shape
    g = group_size
    bf16 = x.dtype == torch.bfloat16
    nrows = count * g
    rows = (sel[:count].long()[:, None] * g
            + torch.arange(g)[None, :]).reshape(-1)
    xf = x.float()
    # ---- gate/up: 64-row tiles, d cut into the plan's splits of chunks
    rt = -(-nrows // KF.ROWS)
    nks = min(KF.splits(pl.grid, rt, pl.max_splits), pl.k_chunks)
    gsum = torch.zeros((nrows, s))
    usum = torch.zeros((nrows, s))
    xt = xf.T                                                # (d, S)
    for ks in range(nks):
        stages = [(c * KF.KC, min((c + 1) * KF.KC, d))
                  for c in KF.split_chunks(ks, pl.k_chunks, nks)]
        for w, out in ((wg, gsum), (wu, usum)):
            if w is None:
                continue
            wt = w[rows]                                     # (M, d)
            p = _mma_stages(torch.zeros((nrows, s)),
                            _passes(wt, xt, False, bf16, one_pass), stages)
            out += p                                         # split order
    ga = torch.relu(gsum) if act_kind == 0 else torch.where(
        gsum > thr, gsum, torch.zeros(()))
    h = ga * usum if wu is not None else ga
    if bf16:
        h = h.to(torch.bfloat16).float()
    # ---- down: the plan's slices of the selected rows, in slice order
    nsl = KF.slices(pl.grid, pl.col_tiles, nrows)
    y = torch.zeros((d, s))
    for sl in range(nsl):
        r0, r1 = KF.slice_range(sl, nrows, nsl)
        wt = wd[rows[r0:r1]].T                               # (d, rows)
        ht = h[r0:r1]                                        # (rows, S)
        y += _mma_stages(torch.zeros((d, s)),
                         _passes(wt, ht, False, bf16, one_pass),
                         [(k0, min(k0 + KF.KR, r1 - r0))
                          for k0 in range(0, r1 - r0, KF.KR)])
    return y.T.contiguous(), h


def _case(seed, s, d, k, g, gated, short):
    rng = np.random.default_rng(seed)
    w = {n: (rng.standard_normal((k, d)) * d ** -0.5).astype(np.float32)
         for n in ("wg_t", "wu_t", "wd_t")}
    if not gated:
        w["wu_t"] = None
    x = rng.standard_normal((s, d)).astype(np.float32)
    pw = JP.pack_signs(jnp.asarray(w["wg_t"]))
    gm, _ = jops.predict_chunk_group_margins(
        pw, jnp.asarray(x), d, jnp.full((s,), 1.0, jnp.float32),
        group_size=g, interpret=True)
    cap = max(1, k // g // 4)
    sel, _ = JS.capacity_select_with_stats(JS.union_margin(gm), cap)
    count = int(sel.count) // 3 if short else int(sel.count)
    return w, x, np.array(sel.indices), count


# name: (seed, S, d, k, G, gated, activation, threshold, short count)
CASES = {
    "gated relu G=8": (2, 20, 256, 512, 8, True, "relu", 0.0, False),
    "gated relu G=8 short count": (3, 20, 256, 512, 8, True, "relu", 0.0,
                                   True),
    "ungated relu G=1": (4, 5, 128, 256, 1, False, "relu", 0.0, False),
    "gated fatrelu G=16": (5, 37, 192, 768, 16, True, "fatrelu", 0.05,
                           False),
    "ungated fatrelu G=8 d=100": (6, 9, 100, 512, 8, False, "fatrelu", 0.0,
                                  False),
}


def _reference(w, x, sel, count, g, act, thr, xdt):
    xj = jnp.asarray(x).astype(xdt)
    jw = [jnp.asarray(w[n]) if w[n] is not None else None
          for n in ("wg_t", "wu_t", "wd_t")]
    y = jops.fused_sparse_mlp_chunk(
        xj, *jw, jnp.asarray(sel), jnp.asarray(count, jnp.int32),
        group_size=g, activation=act, fatrelu_threshold=thr, interpret=True)
    return np.asarray(y)


def _check(case, xname, one_pass):
    seed, s, d, k, g, gated, act, thr, short = CASES[case]
    w, x, sel, count = _case(seed, s, d, k, g, gated, short)
    bf16 = xname == "bfloat16"
    y_ref = _reference(w, x, sel, count, g, act, thr,
                       jnp.bfloat16 if bf16 else jnp.float32)
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
    tw = {n: torch.from_numpy(v) if v is not None else None
          for n, v in w.items()}
    pl = KF.plan(s, d, len(sel) * g, 2 if bf16 else 4, SMS, H100)
    act_kind = 1 if (act == "fatrelu" or thr > 0) else 0
    y, _ = emulate_chunk(xt, tw["wg_t"], tw["wu_t"], tw["wd_t"],
                         torch.from_numpy(sel), count, group_size=g,
                         act_kind=act_kind, thr=thr, pl=pl,
                         one_pass=one_pass)
    y = y.numpy()
    allow = np.zeros_like(y)
    if bf16:
        # h's exact value (float64) near a bf16 rounding boundary: the two
        # sides may round it to neighbouring bf16 values
        rows = (sel[:count][:, None] * g + np.arange(g)[None, :]).reshape(-1)
        xb = np.asarray(xt.float(), np.float64)
        gx = xb @ w["wg_t"][rows].astype(np.float64).T
        ga = np.maximum(gx, 0) if act_kind == 0 else np.where(gx > thr, gx, 0)
        h = ga * (xb @ w["wu_t"][rows].astype(np.float64).T) if gated else ga
        hb = torch.from_numpy(h).float().to(torch.bfloat16).double().numpy()
        ulp = np.abs(hb) * 2.0 ** -7 + 1e-30
        frac = (h - hb) / ulp                   # in [-1/2, 1/2] ulp
        near = np.abs(np.abs(frac) - 0.5) * ulp <= 1e-5 * np.abs(h)
        assert near.sum() <= 2, f"{near.sum()} h near a rounding boundary"
        allow = (near * ulp) @ np.abs(w["wd_t"][rows].astype(np.float64))
    err = np.abs(y - y_ref) - allow
    return bool((err <= TOL["atol"] + TOL["rtol"] * np.abs(y_ref)).all()), \
        float(np.abs(y - y_ref).max())


@pytest.mark.parametrize("xname", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_recipe_matches_reference_kernel(case, xname):
    ok, err = _check(case, xname, one_pass=False)
    assert ok, f"{case} x={xname}: max |y - y_ref| {err:.3e}"


@pytest.mark.parametrize("xname", ["float32", "bfloat16"])
def test_one_pass_tf32_fails_the_same_check(xname):
    """Weights rounded to TF32 once (one MMA a product, no split) are ~1e-3
    off: a different function, which the check above refuses."""
    ok, err = _check("gated relu G=8", xname, one_pass=True)
    assert not ok and err > 1e-4, f"one pass within tolerance: {err:.3e}"


# ------------------------------------------------------------ the plan --

def test_plan_main_shape():
    """S=64 bf16 x at d=4096 over 288 groups of 8: one token tile of 64,
    264 blocks (2 a SM), d cut 7 ways over 36 row tiles (252 items), 8
    slices of the rows for the 32 column tiles of down (256 items)."""
    pl = KF.plan(64, 4096, 2304, 2, SMS, H100)
    assert (pl.nt, pl.token_tile, pl.s_pad, pl.grid) == (8, 64, 64, 264)
    assert (pl.k_chunks, pl.col_tiles) == (128, 32)
    assert KF.splits(pl.grid, 36, pl.max_splits) == 7
    assert KF.slices(pl.grid, pl.col_tiles, 2304) == 8
    # the ring: 4 stages of down's Wd (32 x 132) and hT (64 x 32) tiles,
    # larger than gate/up's Wg, Wu (64 x 32) and x (64 x 32) tiles
    assert pl.smem_bytes == 4 * (32 * 132 * 4 + 64 * 32 * 4) == 100352
    assert 2 * 64 * 32 * 4 + 64 * 32 * 4 <= 32 * 132 * 4 + 64 * 32 * 4
    assert KF.plan(64, 4096, 2304, 4, SMS, H100).smem_bytes == 100352
    # scratch: split partials of g and u, hT, the slices' partials of y
    assert pl.gu_floats == 2 * 264 * 64 * 64
    assert pl.h_stride == 2304 and pl.h_floats == 64 * 2304
    assert pl.part_floats == 8 * 64 * 4096


@pytest.mark.parametrize("s", [1, 8, 9, 17, 64, 65, 128, 256, 1000])
def test_plan_token_tiles(s):
    pl = KF.plan(s, 4096, 2304, 2, SMS, H100)
    assert pl.token_tile == 8 * pl.nt and pl.nt in (1, 2, 4, 8)
    assert pl.s_pad % pl.token_tile == 0 and 0 <= pl.s_pad - s \
        < pl.token_tile
    assert pl.token_tile >= min(s, 64) and (pl.nt == 1 or
                                            pl.token_tile // 2 < s)
    # the split partials stay within a quarter of the weight bytes an
    # item reads: 64 rows x s_pad against 64 rows x its share of d
    assert pl.max_splits * pl.s_pad * 4 <= max(4096, 4 * pl.s_pad)


@pytest.mark.parametrize("d,cap_rows,g", [(4096, 2304, 8), (100, 128, 8),
                                          (196, 192, 16), (4096, 4480, 8),
                                          (128, 64, 1)])
def test_plan_items_cover_rows_and_columns_once(d, cap_rows, g):
    """For every count (every 8th for the large capacities) the kernel's
    gate/up items (64-row tile x split of the 32-column chunks of d) cover
    each selected row x each chunk exactly once, and so do down's items
    (slice of rows starting on a multiple of 8 x 128-column tile); the
    chunks and tiles cover d; the scratch holds every item's partials."""
    pl = KF.plan(64, d, cap_rows, 4, SMS, H100)
    assert (pl.k_chunks - 1) * KF.KC < d <= pl.k_chunks * KF.KC
    assert (pl.col_tiles - 1) * KF.COLS < d <= pl.col_tiles * KF.COLS
    n_sel = cap_rows // g
    for count in range(0, n_sel + 1, 1 if n_sel <= 64 else 8):
        nrows = count * g
        rt = -(-nrows // KF.ROWS)
        nks = min(KF.splits(pl.grid, rt, pl.max_splits), pl.k_chunks)
        cover = np.zeros((nrows, pl.k_chunks), np.int32)
        for item in range(rt * nks):
            r, ks = divmod(item, nks)
            chunks = list(KF.split_chunks(ks, pl.k_chunks, nks))
            assert chunks
            cover[r * KF.ROWS:(r + 1) * KF.ROWS, chunks] += 1
        assert (cover == 1).all()
        assert 2 * rt * nks * KF.ROWS * pl.s_pad <= pl.gu_floats
        nsl = KF.slices(pl.grid, pl.col_tiles, nrows)
        cover = np.zeros((nrows, pl.col_tiles), np.int32)
        for item in range(nsl * pl.col_tiles):
            sl, ct = divmod(item, pl.col_tiles)
            r0, r1 = KF.slice_range(sl, nrows, nsl)
            assert r1 > r0 and r0 % KF.SLICE_UNIT == 0
            cover[r0:r1, ct] += 1
        assert (cover == 1).all()
        assert nsl * 64 * d <= pl.part_floats


@pytest.mark.parametrize("x_elem", [2, 4])
@pytest.mark.parametrize("occ", [1, 2, 3, 8])
def test_plan_grid_resident_and_smem_fits(occ, x_elem):
    """The grid is at most 2 blocks a SM and never more than the card holds
    at once (a cooperative launch needs every block resident); every token
    tile's shared memory fits a block."""
    for s in (1, 9, 33, 64, 300):
        pl = KF.plan(s, 4096, 2304, x_elem, SMS, lambda nt, smem: occ)
        assert pl.grid == min(occ, KF.MAX_BLOCKS_PER_SM) * SMS
        assert pl.grid <= occ * SMS
        assert pl.smem_bytes == KF.STAGES * KF.stage_bytes(pl.nt, x_elem)
        assert pl.smem_bytes <= KF.SMEM_LIMIT


def test_plan_raises_past_its_limits():
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        KF.plan(64, 4096, 2304, 2, SMS, lambda nt, smem: 0)
    with pytest.raises(ValueError, match="multiple of 4"):
        KF.plan(64, 4098, 2304, 2, SMS, H100)
    with pytest.raises(ValueError, match="bad shape"):
        KF.plan(0, 4096, 2304, 2, SMS, H100)
    with pytest.raises(ValueError, match="bad shape"):
        KF.plan(64, 4096, 0, 2, SMS, H100)
    with pytest.raises(ValueError, match=f"limit of {KF.INT32_MAX}"):
        KF.plan(600_000, 4096, 2304, 2, SMS, H100)


def test_chunk_launcher_refuses_cpu_tensors():
    """The launcher takes CUDA tensors only: on the CPU the ops layer runs
    the plain version, and the launcher is never reached."""
    x = torch.zeros((4, 8))
    w = torch.zeros((16, 8))
    sel = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        KF.fused_sparse_mlp_chunk(x, w, w, w, sel, torch.tensor(2),
                                  group_size=8)
