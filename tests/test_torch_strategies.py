"""The port's ``masked`` and ``gather`` strategies against the reference's,
jitted (its margins are then one fused multiply-add, as on its serve path),
with the reference's weights carried over.

k = 512 (64 row groups of 8) with capacity_frac 0.1 gives a capacity of 16
groups, below what random weights predict active, so gather's clamp binds
and ``overflow_frac`` is non-zero.  Stats come from integer counts through
the same float32 arithmetic and must be equal; y is held to
rtol=atol=1e-5 (float32 sums in another order).  A teacher-forced decode of
reduced prosparse-llama2-7b with ``d_ff=512`` runs both strategies through
the port's model against the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as j_reduced
from repro.core import quantize as JQ
from repro.core import selection as JS
from repro.core import sparse_mlp as JSM
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.core import selection as TS
from repro_torch.core import sparse_mlp as TSM
from repro_torch.layers.mlp import mlp_apply
from repro_torch.models import lm as tlm

D, K = 128, 512
TOL = dict(rtol=1e-5, atol=1e-5)
DEAD = TSM.DEAD_SLOT_ALPHA
STRATEGIES = {"masked": (JSM.masked_mlp, TSM.masked_mlp),
              "gather": (JSM.gather_mlp, TSM.gather_mlp)}


def _cfgs(strategy: str, **kw):
    kw = {"activation": "relu", "group_size": 8, "capacity_frac": 0.1,
          **kw}
    ref = JSM.SparseInferConfig(enabled=True, strategy=strategy, **kw)
    return ref, TSM.SparseInferConfig(**dataclasses.asdict(ref))


def _params(seed: int, int8: bool = False):
    params = JSM.init_gated_mlp(jax.random.PRNGKey(seed), D, K,
                                dtype=jnp.float32)
    if int8:
        params = JQ.quantize_mlp_node(params, 32, 8)
    else:
        params = JSM.prepare_sparse_params(params)
    return params, {k: torch.from_numpy(np.array(v))
                    for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def _jitted(strategy: str, cfg):
    fn = STRATEGIES[strategy][0]
    return jax.jit(lambda p, x, a: fn(p, x, cfg, alpha=a, return_stats=True))


def _alpha(kind, b: int):
    if kind == "per-slot+dead":
        return np.asarray([1.0, DEAD, 0.9, 1.1][:b], np.float32)
    return np.float32(kind)


def _run(strategy, jp, tp, x, a, **kw):
    ref_cfg, port_cfg = _cfgs(strategy, **kw)
    y_r, st_r = _jitted(strategy, ref_cfg)(jp, jnp.asarray(x), jnp.asarray(a))
    y_p, st_p = STRATEGIES[strategy][1](tp, torch.from_numpy(x), port_cfg,
                                        alpha=torch.as_tensor(a),
                                        return_stats=True)
    return (np.asarray(y_r), {k: np.asarray(v) for k, v in st_r.items()},
            y_p.numpy(), {k: v.numpy() if torch.is_tensor(v) else v
                          for k, v in st_p.items()})


def _check(y_r, st_r, y_p, st_p):
    np.testing.assert_allclose(y_p, y_r, **TOL)
    assert set(st_p) == set(TSM.MLP_STAT_KEYS)
    for k in TSM.MLP_STAT_KEYS:
        np.testing.assert_array_equal(st_p[k], st_r[k], err_msg=k)


@pytest.mark.parametrize("strategy", ["masked", "gather"])
@pytest.mark.parametrize("alpha", [1.0, 1.03, "per-slot+dead"])
@pytest.mark.parametrize("b", [1, 3])
def test_strategy_output_and_stats(strategy, alpha, b):
    jp, tp = _params(0)
    x = np.random.default_rng(b).standard_normal((b, D)).astype(np.float32)
    y_r, st_r, y_p, st_p = _run(strategy, jp, tp, x, _alpha(alpha, b))
    _check(y_r, st_r, y_p, st_p)
    if strategy == "gather":
        # the clamp binds: the union demands more than 16 of 64 groups
        assert st_p["union_demand_frac"][0] > 16 * 8 / K
        if alpha == 1.0:
            assert st_p["overflow_frac"].max() > 0


@pytest.mark.parametrize("strategy", ["masked", "gather"])
def test_grouped_and_single_token_inputs(strategy):
    """(G, B, d): a union and a selection per group; (d,): one token."""
    jp, tp = _params(1)
    rng = np.random.default_rng(4)
    xg = rng.standard_normal((2, 3, D)).astype(np.float32)
    a = np.asarray([1.0, 1.03, DEAD], np.float32)
    y_r, st_r, y_p, st_p = _run(strategy, jp, tp, xg, a)
    assert y_p.shape == (2, 3, D)
    assert st_p["realized_density"].shape == (2, 3)
    _check(y_r, st_r, y_p, st_p)
    x1 = rng.standard_normal((D,)).astype(np.float32)
    y_r, st_r, y_p, st_p = _run(strategy, jp, tp, x1, np.float32(1.0))
    assert y_p.shape == (D,) and st_p["predicted_density"].shape == ()
    _check(y_r, st_r, y_p, st_p)


@pytest.mark.parametrize("strategy", ["masked", "gather"])
def test_int8_node_and_ungated_fatrelu(strategy):
    """A quantized node runs on its dequantized view; fatrelu and
    use_actual_sparsity off take the strategy's other branches."""
    jp, tp = _params(2, int8=True)
    x = np.random.default_rng(5).standard_normal((3, D)).astype(np.float32)
    _check(*_run(strategy, jp, tp, x, np.float32(1.0)))
    jp, tp = _params(3)
    jp = {k: v for k, v in jp.items() if k != "wu_t"}
    tp = {k: v for k, v in tp.items() if k != "wu_t"}
    _check(*_run(strategy, jp, tp, x, np.float32(1.03),
                 activation="fatrelu", fatrelu_threshold=0.05,
                 use_actual_sparsity=False))


def test_gather_dead_slot_leaves_union():
    """A DEAD_SLOT_ALPHA slot predicts no group: its groups are absent from
    the union, so the live slot gets the selection, the stats and (up to
    the matmul's summation order) the output it gets alone."""
    _, port_cfg = _cfgs("gather")
    _, tp = _params(4)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, D)).astype(np.float32))
    y1, st1 = TSM.gather_mlp(tp, x[:1], port_cfg, alpha=1.0,
                             return_stats=True)
    y2, st2 = TSM.gather_mlp(tp, x, port_cfg,
                             alpha=torch.tensor([1.0, DEAD]),
                             return_stats=True)
    y3 = TSM.gather_mlp(tp, x, port_cfg, alpha=1.0)
    assert float(st2["predicted_density"][1]) == 0.0
    for k in TSM.MLP_STAT_KEYS:
        assert float(st2[k][0]) == float(st1[k][0]), k
    torch.testing.assert_close(y2[:1], y1, rtol=1e-6, atol=1e-6)
    # live, the second row moves the clamped selection
    assert not torch.allclose(y3[:1], y1, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("strategy", ["masked", "gather"])
def test_mlp_apply_dispatches(strategy):
    """The layer hook reaches the strategy through ``apply``, per-layer
    schedule alpha included."""
    ref_cfg, port_cfg = _cfgs(strategy)
    jp, tp = _params(5)
    x = np.random.default_rng(8).standard_normal((2, D)).astype(np.float32)
    y_r, st_r = STRATEGIES[strategy][0](
        jp, jnp.asarray(x), ref_cfg,
        alpha=ref_cfg.alpha_schedule().alpha_for_layer(0, 2),
        return_stats=True)
    y_p, st_p = mlp_apply(tp, torch.from_numpy(x), port_cfg, decode=True,
                          layer_idx=0, num_layers=2, return_stats=True)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
    assert set(st_p) == set(TSM.MLP_STAT_KEYS)
    for k in TSM.MLP_STAT_KEYS:
        np.testing.assert_array_equal(st_p[k].numpy(), np.asarray(st_r[k]),
                                      err_msg=k)


@pytest.mark.parametrize("strategy", ["masked", "gather"])
def test_decode_step_teacher_forced(strategy):
    """Reduced prosparse-llama2-7b with d_ff=512: per-slot alphas with a
    dead slot, 4 teacher-forced steps, logits and (L, B) stats."""
    b, plen, steps, max_len = 3, 6, 4, 16
    cfgs = []
    for reduced in (j_reduced, t_reduced):
        cfg = reduced("prosparse-llama2-7b")
        cfgs.append(cfg.replace(d_ff=512, sparse=dataclasses.replace(
            cfg.sparse, strategy=strategy, capacity_frac=0.25)))
    jcfg, tcfg = cfgs
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = tlm.prepare_sparse(bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    jparams = jlm.prepare_sparse(jparams)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jcfg.vocab, size=(b, plen))
    forced = rng.integers(0, jcfg.vocab, size=(steps, b, 1))
    alphas = (jcfg.sparse.alpha_schedule().alphas(jcfg.n_layers)[:, None]
              + np.asarray([0.1, -0.1, 0.0], np.float32)[None, :])
    alphas[:, 2] = DEAD
    jstep = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg,
                                      collect_stats=True))
    _, jc = jlm.prefill(jparams, jcfg, jnp.asarray(prompt), max_len)
    with torch.inference_mode():
        _, tc = tlm.prefill(tparams, tcfg, torch.from_numpy(prompt), max_len)
    for t in range(steps):
        lens = np.full(b, plen + t, np.int32)
        jl, jc, jst = jstep(jparams, token=jnp.asarray(forced[t]), caches=jc,
                            cache_len=jnp.asarray(lens),
                            alphas=jnp.asarray(alphas))
        with torch.inference_mode():
            tl, tc, tst = tlm.decode_step(
                tparams, tcfg, torch.from_numpy(forced[t]), tc,
                torch.from_numpy(lens), alphas=alphas, collect_stats=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4, err_msg=f"step {t}")
        for k in TSM.MLP_STAT_KEYS:
            np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]),
                                          err_msg=f"step {t} {k}")


@pytest.mark.parametrize("narrow", [16, 40, 64])
def test_selection_helpers_match_reference(narrow):
    """clamp_selection (equal to selecting at the narrow capacity
    directly), mask_from_selection, take_row_groups and expected_capacity
    against the reference's, on tie-heavy integer margins."""
    m = np.random.default_rng(narrow).integers(-6, 3, size=128).astype(
        np.float32)
    j_sel, j_st = JS.capacity_select_with_stats(jnp.asarray(m), 64)
    t_sel, t_st = TS.capacity_select_with_stats(torch.from_numpy(m), 64)
    jc_sel, jc_st = JS.clamp_selection(j_sel, j_st, narrow)
    tc_sel, tc_st = TS.clamp_selection(t_sel, t_st, narrow)
    direct, direct_st = TS.capacity_select_with_stats(torch.from_numpy(m),
                                                      narrow)
    for got, want in ((tc_sel, jc_sel), (tc_st, jc_st)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tc_sel.indices[:narrow].numpy(),
                                  direct.indices.numpy())
    assert int(tc_sel.count) == int(direct.count)
    assert int(tc_st.overflow) == int(direct_st.overflow)
    np.testing.assert_array_equal(
        TS.mask_from_selection(tc_sel, 128).numpy(),
        np.asarray(JS.mask_from_selection(jc_sel, 128)))
    w = np.random.default_rng(1).standard_normal((128, 8, 4)).astype(
        np.float32)
    idx = np.asarray(t_sel.indices[:5])
    np.testing.assert_array_equal(
        TS.take_row_groups(torch.from_numpy(w), torch.from_numpy(idx)).numpy(),
        np.asarray(JS.take_row_groups(jnp.asarray(w), jnp.asarray(idx))))
    for k, sparsity in ((11008, 0.6), (512, 0.93), (128, 0.0)):
        assert TS.expected_capacity(k, sparsity) == \
            JS.expected_capacity(k, sparsity)


@pytest.mark.parametrize("cap", [16, 64, 128])
def test_batched_selection_matches_reference_per_row(cap):
    """capacity_select_with_stats and mask_from_selection over a (G, k)
    batch of margins (gather's grouped input) equal the reference's, row by
    row, tie order included; row 0 selects group 0 beside padding that
    also points at group 0, which must stay in the mask."""
    m = np.random.default_rng(cap).integers(-6, 3, size=(4, 128)).astype(
        np.float32)
    m[0] = 1.0
    m[0, [0, 5, 9]] = -1.0                 # 3 valid, the rest padding
    t_sel, t_st = TS.capacity_select_with_stats(torch.from_numpy(m), cap)
    t_mask = TS.mask_from_selection(t_sel, 128)
    assert bool(t_mask[0, 0]) and int(t_mask[0].sum()) == 3
    for i in range(m.shape[0]):
        j_sel, j_st = JS.capacity_select_with_stats(jnp.asarray(m[i]), cap)
        for got, want in ((t_sel, j_sel), (t_st, j_st)):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a[i].numpy(), np.asarray(b),
                                              err_msg=f"row {i}")
        np.testing.assert_array_equal(
            t_mask[i].numpy(), np.asarray(JS.mask_from_selection(j_sel, 128)),
            err_msg=f"row {i}")
