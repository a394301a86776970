"""The sign-packing kernel (``csrc/sign_pack.cu``) off the card.

- A numpy emulation of the kernel's recipe, as its host plan
  (``kernels/sign_pack.py:plan``) launches it: on the vector route each
  16-byte load's comparisons ``< 0`` make a nibble (float32) or a byte
  (bf16), shifted to the lane's place and ORed over the word's lanes by
  the shuffle butterfly, the loads mapped to words by the kernel's index
  arithmetic; the scalar route's ballot of one element a lane for the
  partial last word, or for every word when a row start is not 16-byte
  aligned.  Held bitwise against the reference's Pallas ``sign_pack`` in
  interpret mode (d % 32 == 0) and against ``ref.sign_pack_ref`` (any d),
  both dtypes and both routes, with -0.0, NaN and all-negative rows.
- An emulation that reads the sign bit instead of comparing, which must
  fail on -0.0 and NaN.
- The plan: the scalar route exactly where a row start is not 16-byte
  aligned, every word made once, the grid within the card's resident
  blocks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro_torch.kernels import ref
from repro_torch.kernels import sign_pack as KS

ELEM = {"float32": 4, "bfloat16": 2}


def _values(rng, rows, d):
    """float32 values with zeros, -0.0, NaN and an all-negative row."""
    v = rng.standard_normal((rows, d)).astype(np.float32)
    v[0, ::7] = 0.0
    v[-1, 1::5] = -0.0
    v[rows // 2, 2::11] = np.nan
    v[rows // 2, 3::13] = -np.nan
    if rows > 2:
        v[1] = -np.abs(v[1]) - 1.0
    return v


def _as(v: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(v)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _flat(t: torch.Tensor) -> np.ndarray:
    """The values the kernel reads, as float32 (a bf16 is the high half of
    its float32), flattened row-major."""
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().astype(np.uint16)
        return (bits.astype(np.uint32) << 16).view(np.float32).ravel()
    return t.numpy().ravel()


def _neg(vals: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore"):
        return vals < 0


def _sign_bit(vals: np.ndarray) -> np.ndarray:
    return (vals.view(np.uint32) >> 31).astype(bool)


def emulate(t: torch.Tensor, ptr: int = 0, neg=_neg) -> np.ndarray:
    """The kernel's words for t (rows, d) at address ``ptr`` (its 16-byte
    alignment picks the route), every word written exactly once."""
    rows, d = t.shape
    elem = t.element_size()
    pl = KS.plan(rows, d, elem, ptr)
    flat = _flat(t)
    w = -(-d // 32)
    e = 16 // elem                       # elements a load
    lanes = 32 // e                      # lanes a word
    out = np.zeros(rows * w, np.uint32)
    hits = np.zeros(rows * w, np.int64)
    wv = pl.vec_words
    nv = rows * wv * lanes
    assert nv == pl.loads
    if nv:
        assert pl.blocks * KS.THREADS * pl.loads_per_thread >= nv
        # the loads each warp makes: c = warp * 32, then a step of UNROLL
        # grid sweeps while c < nv; load u of a step at c + u * span
        n_warps = pl.blocks * KS.WARPS
        span = n_warps * 32
        steps = -(-nv // (span * KS.UNROLL))
        c = (np.arange(n_warps)[:, None] * 32
             + np.arange(steps)[None, :] * span * KS.UNROLL).ravel()
        c = c[c < nv]                    # the warp-uniform loop condition
        i = (c[:, None, None] + np.arange(KS.UNROLL)[None, :, None] * span
             + np.arange(32)[None, None, :]).reshape(-1, 32)
        live = i < nv
        if wv == w:                      # d % 32 == 0: loads run on
            el, word = i * e, i // lanes
        else:
            g = i // lanes
            r = g // wv
            k = g - r * wv
            el = r * d + k * 32 + (i % lanes) * e
            word = r * w + k
        assert (el[live] * elem % 16 == 0).all()
        vals = flat[np.where(live, el, 0)[..., None] + np.arange(e)]
        vals = np.where(live[..., None], vals, 0.0)
        part = (neg(vals).astype(np.uint32)
                << np.arange(e, dtype=np.uint32)).sum(-1, dtype=np.uint32)
        lane = np.arange(32)
        part = part << (e * (lane % lanes)).astype(np.uint32)
        o = 1
        while o < lanes:                 # __shfl_xor_sync butterfly
            part = part | part[:, lane ^ o]
            o <<= 1
        lead = live & (lane % lanes == 0)
        np.add.at(hits, word[lead], 1)
        out[word[lead]] = part[lead]
    ns = w - wv
    for s in range(rows * ns):           # the scalar route: a warp a word
        r, i_w = divmod(s, ns)
        col = (wv + i_w) * 32 + np.arange(32)
        x = np.where(col < d, flat[r * d + np.minimum(col, d - 1)], 0.0)
        ballot = (neg(x).astype(np.uint32)
                  << np.arange(32, dtype=np.uint32)).sum(dtype=np.uint32)
        out[r * w + wv + i_w] = ballot
        hits[r * w + wv + i_w] += 1
    assert (hits == 1).all(), "a word made twice or never"
    return out.view(np.int32).reshape(rows, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(1, 32), (4, 4096), (5, 96),
                                    (64, 256), (3, 1024)])
@pytest.mark.parametrize("ptr", [0, 4])
def test_emulation_matches_pallas_kernel(dtype, rows, d, ptr):
    """d % 32 == 0: against the Pallas kernel in interpret mode, on the
    vector route (aligned) and the scalar one (ptr 4)."""
    v = _values(np.random.default_rng(rows * d + ptr), rows, d)
    t = _as(v, dtype)
    jv = jnp.asarray(v).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    want = np.asarray(jops.sign_pack(jv, interpret=True))
    route = KS.plan(rows, d, ELEM[dtype], ptr).route
    assert route == ("vector" if ptr == 0 else "scalar")
    np.testing.assert_array_equal(emulate(t, ptr), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [5, 24, 33, 1000, 11000])
@pytest.mark.parametrize("ptr", [0, 2])
def test_emulation_matches_plain_version(dtype, d, ptr):
    """Any d: against the plain version, which pads the last word's lanes
    as positive.  d = 24 and 1000 (and 11000 in float32) have aligned rows
    with a partial last word: the vector route with the scalar tail."""
    rows = 3
    v = _values(np.random.default_rng(d + ptr), rows, d)
    t = _as(v, dtype)
    pl = KS.plan(rows, d, ELEM[dtype], ptr)
    assert (pl.route == "vector") == (d * ELEM[dtype] % 16 == 0
                                      and ptr == 0)
    np.testing.assert_array_equal(emulate(t, ptr),
                                  ref.sign_pack_ref(t).numpy())


def test_sign_bit_emulation_fails_on_negative_zero_and_nan():
    """The kernel compares (v < 0); reading the sign bit would pack -0.0
    and -NaN as 1, and the comparison against the plain version sees it."""
    v = np.zeros((2, 64), np.float32)
    v[0, 3] = -0.0
    v[1, 40] = -np.nan
    for dtype in ("float32", "bfloat16"):
        t = _as(v, dtype)
        want = ref.sign_pack_ref(t).numpy()
        np.testing.assert_array_equal(emulate(t), want)
        assert not np.array_equal(emulate(t, neg=_sign_bit), want)


@settings(max_examples=60, deadline=None)
@given(rows=st.integers(1, 9), d=st.integers(1, 300),
       dtype=st.sampled_from(["float32", "bfloat16"]),
       ptr=st.sampled_from([0, 2, 4, 8, 16]),
       seed=st.integers(0, 2 ** 31 - 1))
def test_emulation_matches_plain_version_drawn(rows, d, dtype, ptr, seed):
    v = _values(np.random.default_rng(seed), rows, d)
    t = _as(v, dtype)
    np.testing.assert_array_equal(emulate(t, ptr),
                                  ref.sign_pack_ref(t).numpy())


@pytest.mark.parametrize("elem", [2, 4])
def test_plan_scalar_exactly_where_a_row_start_is_unaligned(elem):
    for d in range(1, 300):
        for ptr in (0, 2, 4, 8, 12, 16, 256 + 4, 4096):
            pl = KS.plan(7, d, elem, ptr)
            aligned = all((ptr + r * d * elem) % 16 == 0 for r in range(7))
            assert pl.route == ("vector" if aligned else "scalar"), (d, ptr)
            w = -(-d // 32)
            assert pl.vec_words == (d // 32 if aligned else 0)
            assert pl.scalar_words == 7 * (w - pl.vec_words)


@pytest.mark.parametrize("rows,d,elem,blocks,per_thread", [
    (4, 4096, 2, 8, 1),                 # x at B=4, bf16: a load a thread
    (1, 4096, 2, 2, 1),
    (64, 4096, 2, 128, 1),              # a gather prefill chunk
    (11008, 4096, 4, 1056, 42),         # the gate weights at load
    (11008, 4096, 2, 1056, 21),
])
def test_plan_main_shapes(rows, d, elem, blocks, per_thread):
    pl = KS.plan(rows, d, elem, 0)
    assert pl.route == "vector" and pl.scalar_words == 0
    assert pl.loads == rows * d * elem // 16
    assert (pl.blocks, pl.loads_per_thread) == (blocks, per_thread)
    assert pl.blocks <= KS.H100_SMS * KS.BLOCKS_PER_SM


def test_plan_limits():
    assert KS.plan(3, 33, 4, 0).blocks == 1          # 6 words, 8 warps
    big = KS.plan(100000, 33, 4, 0)                  # scalar words > grid
    assert big.route == "scalar"
    assert big.blocks == KS.H100_SMS * KS.BLOCKS_PER_SM
    assert KS.plan(5, 64, 4, 0, sms=10).blocks == 1
    for bad in ((0, 32, 4), (1, 0, 4), (1, 32, 8)):
        with pytest.raises(ValueError):
            KS.plan(*bad, 0)


def test_launcher_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA"):
        KS.sign_pack(torch.zeros((2, 32)))
