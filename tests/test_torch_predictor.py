"""The port's sign packing, margins and capacity selection against the
reference.  All of these are integer or single-rounding results, so they
must agree exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictor as JP
from repro.core import selection as JS
from repro_torch.core import predictor as TP
from repro_torch.core import selection as TS


@pytest.mark.parametrize("d", [64, 70, 4096])
def test_pack_unpack_signs_exact(d):
    rng = np.random.default_rng(d)
    v = rng.standard_normal((3, d)).astype(np.float32)
    v[0, :7] = -0.0                 # -0.0 packs as positive
    v[1, ::5] = 0.0
    ref = np.asarray(JP.pack_signs(jnp.asarray(v)))
    port = TP.pack_signs(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(
        TP.unpack_signs(torch.from_numpy(port), d).numpy(),
        np.asarray(JP.unpack_signs(jnp.asarray(ref), d)))
    # bfloat16 inputs pack the same sign bits
    np.testing.assert_array_equal(
        TP.pack_signs(torch.from_numpy(v).to(torch.bfloat16)).numpy(), ref)


@pytest.mark.parametrize("alpha", [1.0, 1.03, "per-token"])
def test_margins_match_jitted_reference(alpha):
    """The jitted reference fuses the margin's multiply-subtract; the port's
    float64-then-round margin must match it bit for bit."""
    rng = np.random.default_rng(1)
    d, k = 4096, 4097
    w = rng.standard_normal((k, d)).astype(np.float32)
    x = rng.standard_normal((2, d)).astype(np.float32)
    a = np.asarray([1.03, 0.97], np.float32) if alpha == "per-token" \
        else np.float32(alpha)
    pw, px = JP.pack_signs(jnp.asarray(w)), JP.pack_signs(jnp.asarray(x))
    ref = np.asarray(jax.jit(JP.margins, static_argnums=2)(
        pw, px, d, jnp.asarray(a)))
    port = TP.margins(torch.from_numpy(np.array(pw)),
                      torch.from_numpy(np.array(px)), d,
                      torch.as_tensor(a)).numpy()
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(
        TP.neg_counts(torch.from_numpy(np.array(pw)),
                      torch.from_numpy(np.array(px))).numpy(),
        np.asarray(JP.neg_counts(pw, px)))


def test_capacity_select_ties_exact_over_draws():
    """Integer margins (alpha = 1) tie constantly: the port's stable sort
    must reproduce lax.top_k's lower-index-first order on every draw."""
    rng = np.random.default_rng(2)
    for _ in range(50):
        m = rng.integers(-4, 4, size=512).astype(np.float32)
        sel_r, st_r = JS.capacity_select_with_stats(jnp.asarray(m), 128)
        sel_p, st_p = TS.capacity_select_with_stats(torch.from_numpy(m), 128)
        np.testing.assert_array_equal(sel_p.indices.numpy(),
                                      np.asarray(sel_r.indices))
        np.testing.assert_array_equal(sel_p.valid.numpy(),
                                      np.asarray(sel_r.valid))
        assert int(sel_p.count) == int(sel_r.count)
        for f in ("predicted", "selected", "overflow", "occupancy"):
            assert float(getattr(st_p, f)) == float(getattr(st_r, f)), f


def test_group_and_union_margins():
    rng = np.random.default_rng(3)
    m = rng.standard_normal((4, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        TS.group_margins(torch.from_numpy(m), 8).numpy(),
        np.asarray(JS.group_margins(jnp.asarray(m), 8)))
    np.testing.assert_array_equal(
        TS.union_margin(torch.from_numpy(m)).numpy(),
        np.asarray(JS.union_margin(jnp.asarray(m))))


def test_alpha_schedule_and_counters():
    ref, port = JP.AlphaSchedule(), TP.AlphaSchedule()
    np.testing.assert_array_equal(port.alphas(32), ref.alphas(32))
    assert port.alpha_for_layer(3, 8) == ref.alpha_for_layer(3, 8)
    for d, k in ((4096, 11008), (70, 33)):
        assert TP.predictor_op_count(d, k) == JP.predictor_op_count(d, k)
        assert TP.predictor_sign_bytes(d, k) == JP.predictor_sign_bytes(d, k)
        assert TP.mlp_macs(d, k) == JP.mlp_macs(d, k)
