"""The sign-bit predictors (``csrc/predict_margins.cuh``, shared by
``predict_group_margins`` and ``predict_chunk_group_margins``) off the
card: the kernel's recipe and its host plan.

- A plain-torch emulation of the recipe: x's signs packed a word a lane
  (its 32 values, bit i for value i), token tiles of the plan, each CTA's
  range of units and its cluster's even shares of the tile's words, the
  gate-sign rows and x signs in rows of ``xstride`` words, 16-row tiles
  and chunks of 4096 columns, per 8-token slice two b1 MMAs a 512-bit span
  (words 4t, 4t+1, then 4t+2, 4t+3 of each lane group t), AND-popcount
  products in int32, n_neg = popc(x) + popc(w) - 2 * products, the margin
  epilogue of the plain version (one rounding), group minima in ascending
  row order and the kept-group counts summed per CTA.  Held bitwise
  against the reference's Pallas ``predict_chunk_group_margins`` and
  ``predict_group_margins`` in interpret mode: bf16 and float32 x, per-row
  alphas with a dead row, S in {1, 16, 17, 64, 130}, B in {1, 4, 16}, G in
  {1, 8, 16}, d=4000 (rows of 125 words: not a multiple of 4) and d=5000
  (two chunks), and plans with few CTAs (several tiles a warp).  An
  emulation that drops each span's second MMA must fail the same check.
- The identity popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b) on random
  words (hypothesis).
- The plan: units cover every row once in contiguous ranges a CTA, no
  group straddles two CTAs, token tiles cover every token once, the
  layout's strides and shared memory, every tile's clusters fit on the
  card at once where they can; its main shapes; it raises past its limits.
- The launcher refuses CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import predictor as JP
from repro.core.sparse_mlp import DEAD_SLOT_ALPHA
from repro.kernels import predict as JK
from repro_torch.core import predictor as P
from repro_torch.kernels import predict as KP

FIT = 15           # clusters of 8 the H100 runs at once (132 SMs)
K = 512


def _popc(v: torch.Tensor) -> torch.Tensor:
    """Bit count of the low 32 bits of an int64 tensor (SWAR)."""
    v = v & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _words(packed: torch.Tensor) -> torch.Tensor:
    """int32 sign words -> their 32 bits in int64."""
    return packed.to(torch.int64) & 0xFFFFFFFF


def pack_recipe(x: torch.Tensor, w: int, plan: KP.MarginsPlan):
    """The kernel's packing of x (S, <= w*32 columns; the ops layer pads it
    with zeros to w*32), tile by tile: the cluster's CTA r takes the words
    [r*T*w/c, (r+1)*T*w/c) of the tile's flattened (token, word) order (c
    CTAs a cluster: 1 up to SOLO_TOKENS tokens a tile, else CLUSTER), a
    lane a word, bit i set when value i of the word's 32 is negative.
    Returns (S, w) words and, per tile, which CTA packed each word."""
    s = x.shape[0]
    xp = torch.zeros((s, w * 32), dtype=torch.float32)
    xp[:, :x.shape[1]] = x.float()
    bits = (xp < 0).to(torch.int64).reshape(s, w, 32)
    words = (bits << torch.arange(32)).sum(-1)               # (s, w)
    owner = []
    for ti in range(plan.token_tiles):
        t = min(plan.tile, s - ti * plan.tile)
        f = torch.arange(t * w)
        own = torch.zeros(t * w, dtype=torch.int64)
        for r in range(plan.cluster):
            own[r * t * w // plan.cluster:(r + 1) * t * w // plan.cluster] = r
        assert bool((own[1:] >= own[:-1]).all()) and len(f) == len(own)
        owner.append(own.reshape(t, w))
    return words, owner


def emulate(pw: torch.Tensor, x: torch.Tensor, alpha: torch.Tensor,
            d_valid: int, g: int, plan: KP.MarginsPlan,
            second_mma: bool = True):
    """What the card computes, in the kernel's tiling and order."""
    k, w = pw.shape
    s = x.shape[0]
    pwx = _words(pw)
    ns = -(-w // 16)                     # 512-bit spans of a row
    n_chunks = -(-ns // 8)
    xw, _ = pack_recipe(x, w, plan)
    n_groups = k // g
    gm = torch.empty((s, n_groups), dtype=torch.float32)
    cnt = torch.zeros((s,), dtype=torch.int32)
    for ti in range(plan.token_tiles):
        tok0 = ti * plan.tile
        t = min(plan.tile, s - tok0)
        xs = torch.zeros((plan.tile_pad, plan.xstride), dtype=torch.int64)
        xs[:t, :xw.shape[1]] = xw[tok0:tok0 + t]
        xpop = _popc(xs).sum(1)
        for cta in range(plan.ctas):
            u0 = cta * plan.n_units // plan.ctas
            u1 = (cta + 1) * plan.n_units // plan.ctas
            r0, r1 = u0 * plan.unit_rows, min(u1 * plan.unit_rows, k)
            if r1 <= r0:
                continue
            n_mt = -(-(r1 - r0) // 16)
            assert n_mt * 16 <= plan.rows_max
            rp = torch.zeros((plan.rows_max, plan.tile_pad),
                             dtype=torch.int64)
            wpop = torch.zeros((plan.rows_max,), dtype=torch.int64)
            for mt in range(n_mt):
                # the rows in shared memory, zero past w and past r1
                a_rows = torch.zeros((16, n_chunks * 128), dtype=torch.int64)
                lo = r0 + mt * 16
                hi = min(lo + 16, r1)
                a_rows[:hi - lo, :w] = pwx[lo:hi]
                assert n_chunks * 128 <= plan.xstride + 128
                for chunk in range(n_chunks):
                    a = a_rows[:, chunk * 128:(chunk + 1) * 128]
                    wpop[mt * 16:mt * 16 + 16] += _popc(a).sum(1)
                    nsp = min(8, ns - chunk * 8)
                    for sl in range(plan.tile_pad // 8):
                        b = xs[sl * 8:sl * 8 + 8,
                               chunk * 128:chunk * 128 + nsp * 16]
                        c = torch.zeros((16, 8), dtype=torch.int64)
                        for j in range(nsp):
                            for m in ((0, 1) if second_mma else (0,)):
                                # chunk t of the k-step: words 4t+2m, +1
                                ws = [16 * j + 4 * tt + 2 * m + e
                                      for tt in range(4) for e in (0, 1)]
                                c += _popc(a[:, None, ws] & b[None, :, ws]
                                           ).sum(-1)
                        rp[mt * 16:mt * 16 + 16, sl * 8:sl * 8 + 8] += c
            rows = r1 - r0
            nn = (xpop[None, :t] + wpop[:rows, None]
                  - 2 * rp[:rows, :t]).T                         # (t, rows)
            assert (nn >= 0).all() and (nn <= w * 32).all()
            m = P.margins_from_counts(nn.to(torch.int32), d_valid,
                                      alpha[tok0:tok0 + t])
            m = m.reshape(t, rows // g, g)
            gmin = m[..., 0]
            for j in range(1, g):                 # ascending rows, fminf
                gmin = torch.fmin(gmin, m[..., j])
            gm[tok0:tok0 + t, r0 // g:r1 // g] = gmin
            cnt[tok0:tok0 + t] += (gmin <= 0).sum(-1, dtype=torch.int32)
    return gm, cnt


def _case(seed: int, s: int, d: int, xdt):
    rng = np.random.default_rng(seed)
    wg = rng.standard_normal((K, d)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32))
    x = x.to(xdt)
    alpha = np.linspace(0.9, 1.1, s).astype(np.float32)
    alpha[s // 2] = DEAD_SLOT_ALPHA
    pw = np.array(JP.pack_signs(jnp.asarray(wg)))
    return pw, x, alpha


def _reference(pw, x, alpha, d, g, chunk: bool):
    """The Pallas kernel in interpret mode, on x zero-padded to w*32."""
    w = pw.shape[1]
    xp = np.zeros((x.shape[0], w * 32), np.float32)
    xp[:, :d] = x.float().numpy()
    xj = jnp.asarray(xp)
    if x.dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)      # exact: the values are bf16
    fn = JK.predict_chunk_group_margins if chunk else \
        JK.predict_group_margins
    gm, cnt = fn(jnp.asarray(pw), xj, jnp.asarray(alpha), d_valid=d,
                 group_size=g, interpret=True)
    return np.asarray(gm), np.asarray(cnt)


def _card(fit):
    """max_clusters of a card that runs ``fit`` clusters of 8 at once and
    8 * fit + 12 CTAs alone (the H100: 15 and 132)."""
    return lambda cluster, smem: fit if cluster > 1 else 8 * fit + 12


def _plan(s, w, g, fit=FIT):
    return KP.margins_plan(s, w, K, g, _card(fit))


XDT = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.mark.parametrize("xdt", list(XDT))
@pytest.mark.parametrize("s,d,g,fit", [
    (1, 4000, 8, FIT), (16, 4000, 8, FIT), (17, 4000, 16, FIT),
    (64, 4000, 1, FIT), (130, 4000, 8, FIT), (64, 5000, 16, FIT),
    (17, 128, 8, 1), (64, 4000, 8, 1)])
def test_recipe_chunk_matches_pallas(s, d, g, fit, xdt):
    pw, x, alpha = _case(s * 7 + d, s, d, XDT[xdt])
    plan = _plan(s, pw.shape[1], g, fit)
    gm, cnt = emulate(torch.from_numpy(pw), x, torch.from_numpy(alpha), d,
                      g, plan)
    gm_r, cnt_r = _reference(pw, x, alpha, d, g, chunk=True)
    np.testing.assert_array_equal(gm.numpy(), gm_r)
    np.testing.assert_array_equal(cnt.numpy(), cnt_r)


@pytest.mark.parametrize("xdt", list(XDT))
@pytest.mark.parametrize("b", [1, 4, 16])
def test_recipe_decode_matches_pallas(b, xdt):
    d, g = 4000, 8
    pw, x, alpha = _case(b, b, d, XDT[xdt])
    plan = _plan(b, pw.shape[1], g)
    gm, cnt = emulate(torch.from_numpy(pw), x, torch.from_numpy(alpha), d,
                      g, plan)
    gm_r, cnt_r = _reference(pw, x, alpha, d, g, chunk=False)
    np.testing.assert_array_equal(gm.numpy(), gm_r)
    np.testing.assert_array_equal(cnt.numpy(), cnt_r)


def test_recipe_without_second_mma_fails():
    """Each 512-bit span takes two MMAs; one alone misses half its words."""
    s, d, g = 16, 4000, 8
    pw, x, alpha = _case(3, s, d, torch.float32)
    plan = _plan(s, pw.shape[1], g)
    gm, _ = emulate(torch.from_numpy(pw), x, torch.from_numpy(alpha), d, g,
                    plan, second_mma=False)
    gm_r, _ = _reference(pw, x, alpha, d, g, chunk=True)
    assert not np.array_equal(gm.numpy(), gm_r)


@pytest.mark.parametrize("xdt", list(XDT))
def test_pack_recipe_is_the_lsb_first_packing(xdt):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((5, 4000)).astype(np.float32))
    x[0, ::3] = 0.0
    x[1, 1::3] = -0.0
    x = x.to(XDT[xdt])
    got, owner = pack_recipe(x, 125, _plan(5, 125, 8))
    np.testing.assert_array_equal(got.numpy(), _words(P.pack_signs(x)).numpy())
    assert (owner[0] == 0).all()          # a tile of 5 tokens: no cluster
    x = torch.cat([x] * 4)                # 20 tokens: a cluster of 8 CTAs
    got, owner = pack_recipe(x, 125, _plan(20, 125, 8))
    np.testing.assert_array_equal(got.numpy(), _words(P.pack_signs(x)).numpy())
    # contiguous, even shares: 20*125/8 words each
    counts = torch.bincount(owner[0].reshape(-1), minlength=KP.CLUSTER)
    assert counts.max() - counts.min() <= 1


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(-2 ** 31, 2 ** 31 - 1), min_size=1, max_size=64),
       st.lists(st.integers(-2 ** 31, 2 ** 31 - 1), min_size=1, max_size=64))
def test_and_popcount_identity(a, b):
    n = min(len(a), len(b))
    wa = _words(torch.tensor(a[:n], dtype=torch.int32))
    wb = _words(torch.tensor(b[:n], dtype=torch.int32))
    assert torch.equal(_popc(wa ^ wb),
                       _popc(wa) + _popc(wb) - 2 * _popc(wa & wb))
    assert int(_popc(wa ^ wb).sum()) == int(
        _popc(wa).sum() + _popc(wb).sum() - 2 * _popc(wa & wb).sum())


def _check_plan(pl: KP.MarginsPlan, s: int, w: int, k: int, g: int,
                fit: int) -> None:
    assert pl.unit_rows % 16 == 0 and pl.unit_rows % g == 0
    assert pl.n_units == -(-k // pl.unit_rows)
    assert pl.cluster == (KP.CLUSTER if pl.tile > KP.SOLO_TOKENS else 1)
    assert pl.ctas % pl.cluster == 0 and pl.ctas >= pl.cluster
    covered = []
    for i in range(pl.ctas):
        u0, u1 = i * pl.n_units // pl.ctas, (i + 1) * pl.n_units // pl.ctas
        covered += range(u0, u1)
        assert (u1 - u0) * pl.unit_rows <= pl.rows_max
    assert covered == list(range(pl.n_units))   # every row once, in order
    assert pl.ctas <= -(-pl.n_units // pl.cluster) * pl.cluster
    tiles = [min(pl.tile, s - i * pl.tile) for i in range(pl.token_tiles)]
    assert min(tiles) >= 1 and sum(tiles) == s
    assert pl.tile <= KP.TILE_TOKENS and pl.tile_pad % 8 == 0
    assert pl.tile <= pl.tile_pad < pl.tile + 8
    assert pl.xstride % 32 == 16 and pl.xstride >= -(-w // 16) * 16
    assert pl.rstride % 32 == 8 and pl.rstride >= pl.tile_pad
    assert pl.smem == KP.margins_smem(pl.tile_pad, pl.xstride, pl.rows_max,
                                      pl.rstride) <= KP.SMEM_LIMIT
    clusters = pl.ctas // pl.cluster
    if pl.cluster > 1 and clusters * pl.token_tiles > fit and clusters > 1:
        # the tiles run in waves only where one cluster fewer a tile would
        # not fit in shared memory
        fewer = -(-pl.n_units // (pl.ctas - pl.cluster)) * pl.unit_rows
        assert KP.margins_smem(pl.tile_pad, pl.xstride, fewer,
                               pl.rstride) > KP.SMEM_LIMIT


@pytest.mark.parametrize("s,w,k,g,fit", [
    (1, 128, 11008, 8, 15), (4, 128, 11008, 8, 15), (16, 128, 11008, 8, 15),
    (17, 128, 11008, 8, 15), (24, 128, 11008, 8, 15),
    (64, 128, 11008, 8, 15), (128, 128, 11008, 8, 15),
    (256, 128, 11008, 8, 15), (257, 128, 11008, 8, 15),
    (64, 125, 11008, 16, 15), (64, 125, 11008, 1, 15), (3, 4, 500, 1, 15),
    (130, 157, 512, 16, 15), (64, 128, 11008, 64, 15),
    (64, 160, 13824, 8, 15), (2000, 128, 11008, 8, 15),
    (64, 128, 11008, 8, 1), (64, 128, 11008, 8, 33),
    (16, 1000, 11008, 8, 15), (64, 512, 11008, 32, 15)])
def test_plan_covers_everything_once(s, w, k, g, fit):
    _check_plan(KP.margins_plan(s, w, k, g, _card(fit)), s, w, k, g, fit)


@pytest.mark.parametrize("s,cluster,ctas,smem", [(4, 1, 132, 63424),
                                                (64, 8, 120, 120704)])
def test_plan_main_shapes(s, cluster, ctas, smem):
    """prosparse-llama2-7b's gate signs (k=11008, w=128, G=8) on the H100
    (132 SMs, 15 clusters of 8 at once): one token tile; the decode batch
    on 132 CTAs, the chunk on 120 in clusters of 8, 96 rows (6 tiles of 16)
    at most a CTA; the shared memory at B=4 and S=64."""
    pl = KP.margins_plan(s, 128, 11008, 8, _card(15))
    assert (pl.tile, pl.token_tiles, pl.cluster, pl.ctas, pl.rows_max,
            pl.unit_rows) == (s, 1, cluster, ctas, 96, 16)
    assert pl.tile_pad == max(8, s) and pl.xstride == 144
    assert pl.smem == smem


@pytest.mark.parametrize("args,err", [
    ((0, 128, 11008, 8), ValueError), ((4, 0, 11008, 8), ValueError),
    ((4, 128, 11008, 0), ValueError), ((4, 128, 11009, 8), ValueError),
    ((4, 128, 0, 8), ValueError),
    ((4, 20000, 11008, 8), ValueError),          # a row of signs too wide
    ((64, 1000, 11008, 256), ValueError),        # a unit of rows too large
    ((64 * 65536, 128, 11008, 8), ValueError)])  # token tiles past 65535
def test_plan_raises_past_its_limits(args, err):
    with pytest.raises(err):
        KP.margins_plan(*args, _card(15))


def test_plan_raises_when_no_cluster_fits():
    with pytest.raises(RuntimeError):
        KP.margins_plan(4, 128, 11008, 8, lambda c, smem: 0)


@pytest.mark.parametrize("name", ["predict_group_margins",
                                  "predict_chunk_group_margins"])
def test_launcher_refuses_cpu_tensors(name):
    pw = torch.zeros((16, 4), dtype=torch.int32)
    x = torch.zeros((2, 128))
    with pytest.raises(ValueError):
        getattr(KP, name)(pw, x, torch.ones(2), d_valid=128, group_size=8)
