"""The negative-product counts (``csrc/predict_counts.cu``, the counts
instantiation of ``csrc/predict_margins.cuh``: x's packed words as its
source of x, the counts epilogue) off the card: the kernel's recipe and its
host plan.

- A plain-torch emulation of the recipe: token tiles of the plan, each
  CTA's range of 16-row units, the gate-sign rows and x's packed words in
  rows of ``xstride`` words (pads zero, as the kernel zeroes them), per
  512-bit span two b1 MMAs (words 4t, 4t+1, then 4t+2, 4t+3 of each lane
  group t), AND-popcount products in int32, n_neg = popc(x) + popc(w) -
  2 * products, written through the kernel's cells of 8 rows x 4 tokens.
  Held bitwise against the reference's Pallas ``predict_counts`` in
  interpret mode: k in {16, 24, 1000, 11000, 11008}, d in {32, 100, 4000,
  4096}, B in {1, 4, 5, 16, 17, 64, 65}, random, all-ones and all-zero
  words.  Every (token, row) is written exactly once.  An emulation that
  drops each span's second MMA, or leaves x's pad words unzeroed, must
  fail the same check.
- The plan (``margins_plan(..., counts=True)``): cluster 1, units of 16
  rows, token tiles of at most 64; every (token, row) covered once at B up
  to 257; its main shapes (B=4, S=64 on k=11008, w=128); the shared memory
  of the host formula equal to the header's ``smem_bytes``; it raises past
  its limits.
- The launcher refuses CPU tensors.
"""
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import predict as JK
from repro_torch.kernels import predict as KP
from test_torch_predict_hopper import _card, _popc, _words

CUH = KP.build.CSRC / "predict_margins.cuh"


def _plan(s: int, w: int, k: int, fit: int = 15) -> KP.MarginsPlan:
    return KP.margins_plan(s, w, k, 1, _card(fit), counts=True)


def write_cells(rows: int, t: int):
    """The counts epilogue's stores of one CTA and token tile, in order: a
    warp at a time takes a cell of 8 rows x 4 tokens, lane l the row
    8*rc + (l & 7) and the token 4*bc + (l >> 3); cell c = bc * n_rc + rc.
    Returns the (row, token) of every lane that stores."""
    n_rc = -(-rows // 8)
    c = torch.arange(n_rc * -(-t // 4))[:, None]
    lane = torch.arange(32)[None, :]
    bc = c // n_rc
    r = (c - bc * n_rc) * 8 + (lane & 7)
    b = bc * 4 + (lane >> 3)
    keep = (r < rows) & (b < t)
    return r[keep], b[keep]


def _ctas(plan: KP.MarginsPlan, k: int):
    for cta in range(plan.ctas):
        u0 = cta * plan.n_units // plan.ctas
        u1 = (cta + 1) * plan.n_units // plan.ctas
        r0, r1 = u0 * plan.unit_rows, min(u1 * plan.unit_rows, k)
        if r1 > r0:
            yield r0, r1


def emulate(pw: torch.Tensor, px: torch.Tensor, plan: KP.MarginsPlan,
            second_mma: bool = True, x_pad_fill: int = 0):
    """What the card computes, in the kernel's tiling and order: the (S, k)
    counts and how many times each was written."""
    k, w = pw.shape
    s = px.shape[0]
    pwx, pxx = _words(pw), _words(px)
    ns = -(-w // 16)                     # 512-bit spans of a row
    out = torch.full((s, k), -1, dtype=torch.int64)
    writes = torch.zeros((s, k), dtype=torch.int64)
    for ti in range(plan.token_tiles):
        tok0 = ti * plan.tile
        t = min(plan.tile, s - tok0)
        # the tile's words by bulk copies; the kernel zeroes words [w,
        # xstride) and the pad tokens
        xs = torch.full((plan.tile_pad, plan.xstride), x_pad_fill,
                        dtype=torch.int64)
        xs[t:] = 0
        xs[:t, :w] = pxx[tok0:tok0 + t]
        xpop = _popc(xs).sum(1)
        for r0, r1 in _ctas(plan, k):
            rows = r1 - r0
            n_mt = -(-rows // 16)
            assert n_mt * 16 <= plan.rows_max
            a = torch.zeros((n_mt * 16, ns * 16), dtype=torch.int64)
            a[:rows, :w] = pwx[r0:r1]
            wpop = _popc(a).sum(1)       # from the A fragments
            rp = torch.zeros((n_mt * 16, plan.tile_pad), dtype=torch.int64)
            for j in range(ns):          # chunks of 8 spans, in order
                for m in ((0, 1) if second_mma else (0,)):
                    # chunk t of the k-step: words 4t+2m, 4t+2m+1
                    ws = [16 * j + 4 * tt + 2 * m + e
                          for tt in range(4) for e in (0, 1)]
                    rp += _popc(a[:, None, ws] & xs[None, :, ws]).sum(-1)
            r, b = write_cells(rows, t)
            nn = xpop[b] + wpop[r] - 2 * rp[r, b]
            if second_mma and not x_pad_fill:
                assert (nn >= 0).all() and (nn <= 32 * w).all()
            out[tok0 + b, r0 + r] = nn
            writes.index_put_((tok0 + b, r0 + r), torch.ones_like(nn),
                              accumulate=True)
    return out, writes


def _signs(rng, shape, kind: str) -> np.ndarray:
    if kind == "ones":
        return np.full(shape, -1, np.int32)
    if kind == "zeros":
        return np.zeros(shape, np.int32)
    return rng.integers(-2 ** 31, 2 ** 31, size=shape, dtype=np.int64) \
        .astype(np.int32)


def _inputs(k, d, b, kinds, seed):
    rng = np.random.default_rng(seed)
    w = -(-d // 32)
    return _signs(rng, (k, w), kinds[0]), _signs(rng, (b, w), kinds[1])


def _reference(pw: np.ndarray, px: np.ndarray) -> np.ndarray:
    """The Pallas kernel in interpret mode."""
    return np.asarray(JK.predict_counts(jnp.asarray(pw), jnp.asarray(px),
                                        interpret=True))


CASES = [  # k, d, B, (gate-sign words, x words)
    (16, 32, 1, ("random", "random")),
    (16, 100, 5, ("random", "random")),
    (24, 100, 17, ("random", "random")),
    (24, 4000, 4, ("random", "random")),
    (24, 4096, 65, ("ones", "ones")),
    (16, 32, 64, ("ones", "zeros")),
    (1000, 4000, 65, ("random", "random")),
    (1000, 4096, 64, ("random", "random")),
    (1000, 100, 16, ("zeros", "ones")),
    (1000, 4000, 1, ("random", "zeros")),
    (11008, 4096, 4, ("random", "random")),
    (11008, 4000, 5, ("random", "random")),
    (11000, 4096, 17, ("random", "random")),
    (11008, 4096, 1, ("ones", "ones")),
]


@pytest.mark.parametrize("k,d,b,kinds", CASES)
def test_recipe_matches_pallas(k, d, b, kinds):
    pw, px = _inputs(k, d, b, kinds, seed=k * 7 + d + b)
    plan = _plan(b, pw.shape[1], k)
    got, writes = emulate(torch.from_numpy(pw), torch.from_numpy(px), plan)
    assert (writes == 1).all()           # every (token, row) once
    want = _reference(pw, px)
    np.testing.assert_array_equal(got.numpy(), want)
    if kinds == ("ones", "zeros") or kinds == ("zeros", "ones"):
        assert (want == 32 * pw.shape[1]).all()   # the largest count
    if kinds == ("ones", "ones"):
        assert (want == 0).all()         # popc terms of 32w each cancel


@pytest.mark.parametrize("b", [4, 17, 65])
def test_recipe_with_few_ctas_matches_pallas(b):
    """A card that runs 2 CTAs at once: as few CTAs as shared memory lets a
    tile have, more than 8 16-row tiles each, so a warp takes several."""
    pw, px = _inputs(1000, 4000, b, ("random", "random"), seed=b)
    plan = KP.margins_plan(b, pw.shape[1], 1000, 1, lambda c, smem: 2,
                           counts=True)
    assert plan.rows_max > 16 * KP.THREADS // 32
    got, writes = emulate(torch.from_numpy(pw), torch.from_numpy(px), plan)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got.numpy(), _reference(pw, px))


@pytest.mark.parametrize("mutation", ["no_second_mma", "x_pads_unzeroed"])
def test_recipe_mutations_fail(mutation):
    """Each 512-bit span takes two MMAs, and popc(x) counts x's pad words:
    one MMA alone misses half the words, stale pads add bits."""
    pw, px = _inputs(1000, 4000, 16, ("random", "random"), seed=3)
    plan = _plan(16, pw.shape[1], 1000)
    kw = ({"second_mma": False} if mutation == "no_second_mma"
          else {"x_pad_fill": 0xFFFFFFFF})
    got, _ = emulate(torch.from_numpy(pw), torch.from_numpy(px), plan, **kw)
    assert not np.array_equal(got.numpy(), _reference(pw, px))


@pytest.mark.parametrize("s,w,k,fit", [
    (1, 128, 11008, 15), (4, 128, 11008, 15), (5, 125, 11000, 15),
    (16, 128, 11008, 15), (17, 4, 24, 15), (64, 128, 11008, 15),
    (65, 125, 11008, 15), (128, 128, 11008, 15), (256, 128, 11008, 15),
    (257, 128, 11000, 15), (64, 1, 16, 15), (64, 128, 11008, 1),
    (3, 157, 13824, 15), (130, 160, 13824, 33)])
def test_plan_covers_every_output_once(s, w, k, fit):
    pl = _plan(s, w, k, fit)
    assert pl.cluster == 1 and pl.unit_rows == 16
    assert pl.n_units == -(-k // 16) and pl.ctas <= pl.n_units
    assert pl.tile <= KP.TILE_TOKENS and pl.tile <= pl.tile_pad < pl.tile + 8
    assert pl.xstride % 32 == 16 and pl.xstride >= -(-w // 16) * 16
    assert pl.rstride % 32 == 8 and pl.rstride >= pl.tile_pad
    assert pl.smem == KP.margins_smem(pl.tile_pad, pl.xstride, pl.rows_max,
                                      pl.rstride, True) <= KP.SMEM_LIMIT
    writes = torch.zeros((s, k), dtype=torch.int64)
    for ti in range(pl.token_tiles):
        tok0 = ti * pl.tile
        t = min(pl.tile, s - tok0)
        assert t >= 1
        for r0, r1 in _ctas(pl, k):
            assert r1 - r0 <= pl.rows_max
            r, b = write_cells(r1 - r0, t)
            writes.index_put_((tok0 + b, r0 + r), torch.ones_like(r),
                              accumulate=True)
    assert (writes == 1).all()


@pytest.mark.parametrize("s,ctas,rows_max,tile_pad,smem", [
    (4, 132, 96, 8, 63392), (64, 132, 96, 64, 120448)])
def test_plan_main_shapes(s, ctas, rows_max, tile_pad, smem):
    """prosparse-llama2-7b's gate signs (k=11008, w=128) on the H100 (132
    CTAs of 227 KB at once): a gather decode step's B=4 and a gather
    prefill chunk's S=64, each one token tile on 132 CTAs of 96 rows,
    cluster 1."""
    pl = _plan(s, 128, 11008)
    assert (pl.tile, pl.token_tiles, pl.cluster, pl.ctas, pl.rows_max,
            pl.tile_pad, pl.xstride, pl.smem) == (s, 1, 1, ctas, rows_max,
                                                  tile_pad, 144, smem)


def _device_smem_bytes():
    """The header's smem_bytes(p) as a Python function of a plan."""
    text = CUH.read_text()
    body = text[text.index("smem_bytes(const Plan& p) {"):]
    body = body[body.index("return") + len("return"):body.index(";")]
    body = re.sub(r"//[^\n]*", "", body).replace("(size_t)", "")
    body = re.sub(r"\(p\.counts \? (\d+) : (\d+)\)",
                  r"(\1 if p.counts else \2)", body)
    assert "?" not in body and "size_t" not in body
    return lambda p: eval(" ".join(body.split()), {"p": p})


@pytest.mark.parametrize("counts", [True, False])
@pytest.mark.parametrize("s,w,k", [(1, 128, 11008), (4, 128, 11008),
                                   (64, 128, 11008), (65, 125, 11000),
                                   (257, 4, 24)])
def test_host_and_device_shared_memory_agree(s, w, k, counts):
    pl = KP.margins_plan(s, w, k, 1, _card(15), counts=counts)
    p = types.SimpleNamespace(rows_max=pl.rows_max, xstride=pl.xstride,
                              tile_pad=pl.tile_pad, rstride=pl.rstride,
                              counts=counts)
    assert _device_smem_bytes()(p) == pl.smem


@pytest.mark.parametrize("s,w,k", [
    (0, 128, 11008), (4, 0, 11008), (4, 128, 0),
    (4, 20000, 11008),             # a row of signs too wide
    (64 * 65536, 128, 11008)])     # token tiles past 65535
def test_plan_raises_past_its_limits(s, w, k):
    with pytest.raises(ValueError):
        KP.margins_plan(s, w, k, 1, _card(15), counts=True)


def test_plan_refuses_groups_and_no_fit():
    with pytest.raises(ValueError):       # counts are per row: G = 1
        KP.margins_plan(4, 128, 11008, 8, _card(15), counts=True)
    with pytest.raises(RuntimeError):
        KP.margins_plan(4, 128, 11008, 1, lambda c, smem: 0, counts=True)


def test_launcher_refuses_cpu_tensors():
    pw = torch.zeros((16, 4), dtype=torch.int32)
    px = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        KP.predict_counts(pw, px)
