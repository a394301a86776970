"""The plain versions of the ``sign_pack`` and ``predict_counts`` kernels
(what the port's ops layer runs on CPU tensors) against the reference's
Pallas kernels in interpret mode and its plain versions, over the shape and
dtype sweeps of ``tests/test_kernels.py``.  Sign words and popcounts are
integers, and the margin epilogue is one rounding as in the jitted
reference, so everything must agree exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictor as JP
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import predictor as TP
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.core.sparse_mlp import DEAD_SLOT_ALPHA


def _rand(rng, shape, dtype: str) -> np.ndarray:
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "int8":
        return (x * 32).astype(np.int8)
    return x


def _both(v: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        return (jnp.asarray(v).astype(jnp.bfloat16),
                torch.from_numpy(v).to(torch.bfloat16))
    return jnp.asarray(v), torch.from_numpy(v)


@pytest.mark.parametrize("rows,d", [(8, 32), (16, 128), (64, 2048),
                                    (13824 // 32, 5120 // 4), (5, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sign_pack_matches_pallas_kernel(rows, d, dtype):
    v = _rand(np.random.default_rng(rows + d), (rows, d), dtype)
    v[0, :5] = 0                      # zeros pack positive
    if dtype != "int8":
        v[-1, -7:] = -0.0             # and so does -0.0
    jv, tv = _both(v, dtype)
    want = np.asarray(jops.sign_pack(jv, interpret=True))
    np.testing.assert_array_equal(want, np.asarray(jref.sign_pack_ref(jv)))
    np.testing.assert_array_equal(tref.sign_pack_ref(tv).numpy(), want)
    np.testing.assert_array_equal(tops.sign_pack(tv).numpy(), want)


@pytest.mark.parametrize("shape", [(4, 37), (3, 4000), (2, 3, 64),
                                   (2, 3, 70)])
def test_sign_pack_odd_width_and_leading_dims(shape):
    """Odd widths (the reference's ops layer sends them to its oracle;
    the port's kernel packs the missing lanes as positive) and leading
    batch dims."""
    v = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    want = np.asarray(jops.sign_pack(jnp.asarray(v), interpret=True))
    got = tops.sign_pack(torch.from_numpy(v)).numpy()
    assert got.shape == shape[:-1] + (-(-shape[-1] // 32),)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,d,b", [(64, 128, 1), (512, 256, 4),
                                   (1728, 640, 2), (128, 4096, 16),
                                   (96, 100, 24)])
def test_predict_counts_matches_pallas_kernel(k, d, b):
    rng = np.random.default_rng(k + b)
    w = rng.standard_normal((k, d)).astype(np.float32)
    x = rng.standard_normal((b, d)).astype(np.float32)
    pw, px = JP.pack_signs(jnp.asarray(w)), JP.pack_signs(jnp.asarray(x))
    want = np.asarray(jops.predict_counts(pw, px, interpret=True))
    np.testing.assert_array_equal(want,
                                  np.asarray(jref.predict_counts_ref(pw, px)))
    tpw, tpx = torch.from_numpy(np.array(pw)), torch.from_numpy(np.array(px))
    np.testing.assert_array_equal(tref.predict_counts_ref(tpw, tpx).numpy(),
                                  want)
    np.testing.assert_array_equal(tops.predict_counts(tpw, tpx).numpy(),
                                  want)


def test_predict_counts_leading_dims():
    """(G, B, w) packed inputs, as the grouped gather strategy sends."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    x = rng.standard_normal((2, 3, 96)).astype(np.float32)
    pw, px = JP.pack_signs(jnp.asarray(w)), JP.pack_signs(jnp.asarray(x))
    want = np.asarray(jops.predict_counts(pw, px, interpret=True))
    got = tops.predict_counts(torch.from_numpy(np.array(pw)),
                              torch.from_numpy(np.array(px))).numpy()
    assert got.shape == (2, 3, 64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alpha", [1.0, 1.02, 1.03, "per-slot+dead"])
def test_predict_margins_match_jitted_reference(alpha):
    """The reference's kernel-backed margins, jitted (one fused
    multiply-add, as on the serve path), against the port's counts plus its
    float64 epilogue: bitwise; and equal to ``core.predictor.margins``."""
    rng = np.random.default_rng(11)
    d, k, b = 4096, 1024, 3
    w = rng.standard_normal((k, d)).astype(np.float32)
    x = rng.standard_normal((b, d)).astype(np.float32)
    a = (np.asarray([1.03, 0.97, DEAD_SLOT_ALPHA], np.float32)
         if alpha == "per-slot+dead" else np.float32(alpha))
    pw, px = JP.pack_signs(jnp.asarray(w)), JP.pack_signs(jnp.asarray(x))
    ja = jnp.asarray(a)
    if ja.ndim:
        ja = ja[:, None]      # the reference's ops epilogue does not add
        #                       the neuron axis itself
    want = np.asarray(jax.jit(
        lambda pw, px, a: jops.predict_margins(pw, px, d, a, interpret=True)
    )(pw, px, ja))
    tpw, tpx = torch.from_numpy(np.array(pw)), torch.from_numpy(np.array(px))
    got = tops.predict_margins(tpw, tpx, d, torch.as_tensor(a)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, TP.margins(tpw, tpx, d, torch.as_tensor(a)).numpy())


def test_cpu_calls_launch_nothing():
    tops.reset_launch_counts()
    v = torch.randn(3, 64)
    pw = tops.sign_pack(torch.randn(16, 64))
    tops.predict_margins(pw, tops.sign_pack(v), 64, 1.0)
    assert all(n == 0 for n in tops.launch_counts().values())
