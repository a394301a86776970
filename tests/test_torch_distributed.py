"""The sharded sparse decode of the port against the JAX package on one
device: ``runtime/distributed.py`` against the reference's meshless
``emulated_apply``, the shard-grid checks, ``DistributedController`` and
the sharded server.

The MLP cases run at d=128, k=512 (64 row groups of 8) with
capacity_frac 0.1: a capacity of 16 groups, 8 a shard at tp_shards=2 and 4
at 4, well below what random weights predict active, so every shard's
clamp binds.  The reference runs under ``jax.jit`` (its margins are then
one fused multiply-add, as on its serve path).  Stats and the per-shard
riders come from integer counts and must be equal; y is held to
rtol=atol=1e-5, above the reference's own drift between paths it calls
bitwise (6e-8 to 1.4e-6), as ``tests/test_torch_strategies.py`` holds the
unsharded strategies.  The model and server cases run reduced
prosparse-llama2-7b with ``d_ff=512``: logits within 1e-4 as in
``tests/test_torch_archs.py``; tokens, stats, the controller's report (to
1e-5, as ``tests/test_torch_controller.py``), the bucket sequence, the pool's
counters and the gauges equal.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ControllerConfig as JControllerConfig
from repro.configs.base import MetricsConfig as JMetricsConfig
from repro.configs.base import PagedKVConfig as JPagedKVConfig
from repro.configs.base import DEFAULT_SLA_TIERS as J_TIERS
from repro.configs.registry import reduced_config as j_reduced
from repro.core import quantize as JQ
from repro.core import sparse_mlp as JSM
from repro.core.predictor import AlphaSchedule as JAlphaSchedule
from repro.models import lm as jlm
from repro.runtime import controller as jctl
from repro.runtime import distributed as JDD
from repro.runtime import metrics as jmetrics
from repro.runtime import server as jserver
from repro.sharding import sparse as JSS
from repro_torch import bridge
from repro_torch.configs.base import (DEFAULT_SLA_TIERS, ControllerConfig,
                                      MetricsConfig, PagedKVConfig)
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.core import sparse_mlp as TSM
from repro_torch.core.predictor import AlphaSchedule
from repro_torch.kernels import sparse_mlp_fused as KF
from repro_torch.layers.mlp import mlp_apply
from repro_torch.models import lm as tlm
from repro_torch.runtime import controller as tctl
from repro_torch.runtime import distributed as TDD
from repro_torch.runtime import metrics as tmetrics
from repro_torch.runtime.server import Request, Server, ServeConfig
from repro_torch.sharding import sparse as TSS

D, K, QG = 128, 512, 16
B = 4
TOL = dict(rtol=1e-5, atol=1e-5)
DEAD = TSM.DEAD_SLOT_ALPHA
GRIDS = ((1, 2), (2, 2), (1, 4), (2, 1))       # (dp_shards, tp_shards)
STRATEGIES = ("masked", "gather", "pallas")
ARCH = "prosparse-llama2-7b"


def _sparse_cfgs(strategy: str, ds: int, ms: int, **kw):
    """(reference config, port config) of one shard grid; an axis of 1 is
    left unset (0), as a server would see it."""
    kw = {"activation": "relu", "group_size": 8, "capacity_frac": 0.1,
          "tp_shards": ms if ms > 1 else 0,
          "dp_shards": ds if ds > 1 else 0, **kw}
    ref = JSM.SparseInferConfig(enabled=True, strategy=strategy, **kw)
    return ref, TSM.SparseInferConfig(**dataclasses.asdict(ref))


@functools.lru_cache(maxsize=None)
def _mlp_params(seed: int, int8: bool):
    params = JSM.init_gated_mlp(jax.random.PRNGKey(seed), D, K,
                                dtype=jnp.float32)
    params = (JQ.quantize_mlp_node(params, QG, 8) if int8
              else JSM.prepare_sparse_params(params))
    return params, {k: torch.from_numpy(np.array(v))
                    for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def _ref_sharded(strategy: str, cfg):
    return jax.jit(lambda p, x, a: JDD.sharded_apply(
        p, x, cfg, a, strategy=strategy, return_stats=True))


def _alpha(kind: str) -> np.ndarray:
    if kind == "per-token+dead":
        return np.asarray([1.0, DEAD, 0.9, 1.1], np.float32)
    return np.float32(1.03)


def _x(seed: int, b: int = B) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, D)).astype(
        np.float32)


def _both(strategy, jc, tc, int8, x, a, seed=0):
    jp, tp = _mlp_params(seed, int8)
    y_r, st_r = _ref_sharded(strategy, jc)(jp, jnp.asarray(x),
                                           jnp.asarray(a))
    y_p, st_p = TSM.apply(tp, torch.from_numpy(x), tc,
                          alpha=torch.as_tensor(a), return_stats=True)
    return (np.asarray(y_r), {k: np.asarray(v) for k, v in st_r.items()},
            y_p.numpy(), {k: v.numpy() for k, v in st_p.items()})


def _same_stats(st_p: dict, st_r: dict, msg=""):
    assert set(st_p) == set(st_r), (msg, set(st_p) ^ set(st_r))
    for k in st_r:
        np.testing.assert_array_equal(st_p[k], st_r[k], err_msg=f"{msg} {k}")


# ------------------------------------------------------------ MLP level --

@pytest.mark.parametrize("alpha", ["scalar", "per-token+dead"])
@pytest.mark.parametrize("ds,ms", GRIDS)
@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_apply_matches_reference(strategy, int8, ds, ms, alpha):
    """``core.sparse_mlp.apply`` of a sharded config against the
    reference's emulated grid: y within the tolerance, every stat and rider
    equal; the riders, summed, are the realized density; a dead slot adds
    nothing to its block's union and has nothing of its own."""
    jc, tc = _sparse_cfgs(strategy, ds, ms)
    y_r, st_r, y_p, st_p = _both(strategy, jc, tc, int8, _x(ds * 10 + ms),
                                 _alpha(alpha))
    np.testing.assert_allclose(y_p, y_r, **TOL)
    _same_stats(st_p, st_r, f"{strategy} {ds}x{ms}")
    assert (TSM.SHARD_STAT_KEY in st_p) == (ms > 1)
    if ms > 1:
        assert st_p[TSM.SHARD_STAT_KEY].shape == (B, ms)
        np.testing.assert_allclose(st_p[TSM.SHARD_STAT_KEY].sum(-1) / ms,
                                   st_p["realized_density"], atol=1e-6)
    if alpha == "per-token+dead":
        for k in ("predicted_density", "realized_density"):
            assert st_p[k][1] == 0.0, k
        if ms > 1:
            np.testing.assert_array_equal(st_p[TSM.SHARD_STAT_KEY][1], 0.0)


@pytest.mark.parametrize("caps", [(2, 8), (2, 8, 4, 8)])
@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
@pytest.mark.parametrize("strategy", ["gather", "pallas"])
def test_heterogeneous_bucket_tuple_matches_reference(strategy, int8, caps):
    """A per-shard bucket tuple: each shard clamps to its own entry of
    ``shard_bucket_caps`` (dp_shards=2); equal to the reference's, and a
    shard's realized rider never exceeds its own rung."""
    ms = len(caps)
    jc, tc = _sparse_cfgs(strategy, 2, ms, shard_bucket_caps=caps,
                          capacity_override=max(caps) * ms)
    y_r, st_r, y_p, st_p = _both(strategy, jc, tc, int8, _x(7),
                                 _alpha("per-token+dead"), seed=3)
    np.testing.assert_allclose(y_p, y_r, **TOL)
    _same_stats(st_p, st_r, f"{strategy} {caps}")
    k_l = K // ms
    rung = np.asarray(caps, np.float32) * 8 / k_l
    assert (st_p[TSM.SHARD_STAT_KEY] <= rung[None] + 1e-7).all()
    assert (st_p[TSM.SHARD_UNION_KEY] > rung[None]).any()   # clamps bind


def test_unsharded_grid_paths_match_reference():
    """No stats (grid 2 x 2), and a single token (d,) (grid 1 x 2): the
    port's outputs against the reference's."""
    jp, tp = _mlp_params(0, False)
    x = _x(11)
    for strategy in STRATEGIES:
        jc, tc = _sparse_cfgs(strategy, 2, 2)
        y_r = jax.jit(lambda p, xx: JDD.sharded_apply(
            p, xx, jc, 1.0, strategy=strategy))(jp, jnp.asarray(x))
        y_p = TSM.apply(tp, torch.from_numpy(x), tc, alpha=1.0)
        np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
        jc, tc = _sparse_cfgs(strategy, 1, 2)
        y1, st1 = TDD.sharded_apply(tp, torch.from_numpy(x[0]), tc, 1.0,
                                    strategy=strategy, return_stats=True)
        y1r, st1r = jax.jit(lambda p, xx: JDD.sharded_apply(
            p, xx, jc, 1.0, strategy=strategy, return_stats=True))(
                jp, jnp.asarray(x[0]))
        np.testing.assert_allclose(y1.numpy(), np.asarray(y1r), **TOL)
        _same_stats({k: v.numpy() for k, v in st1.items()},
                    {k: np.asarray(v) for k, v in st1r.items()}, strategy)
        assert st1[TSM.SHARD_STAT_KEY].shape == (2,)


@pytest.mark.parametrize("ds,ms", GRIDS)
@pytest.mark.parametrize("strategy", ["gather", "pallas"])
def test_selection_masks_match_reference(strategy, ds, ms):
    """The (ds, k/G) selected-group masks, with a per-shard clamp when
    tensor-sharded."""
    kw = ({"shard_bucket_caps": (2,) + (8,) * (ms - 1),
           "capacity_override": 8 * ms} if ms > 1 else {})
    jc, tc = _sparse_cfgs(strategy, ds, ms, **kw)
    jp, tp = _mlp_params(0, False)
    x, a = _x(5), _alpha("per-token+dead")
    want = jax.jit(lambda p, xx, aa: JDD.selection_masks(
        p, xx, jc, aa, strategy=strategy))(jp, jnp.asarray(x),
                                           jnp.asarray(a))
    got = TDD.selection_masks(tp, torch.from_numpy(x), tc,
                              torch.from_numpy(a), strategy=strategy)
    assert got.shape == (ds, K // 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="union"):
        TDD.selection_masks(tp, torch.from_numpy(x), tc, 1.0,
                            strategy="masked")


def test_grid_helpers_match_reference():
    for kw in ({"tp_shards": 2}, {"tp_shards": 4, "dp_shards": 2},
               {"dp_shards": 2}, {"tp_shards": 2,
                                  "shard_bucket_caps": (4, 8),
                                  "capacity_override": 16}):
        jc = JSM.SparseInferConfig(capacity_frac=0.1, **kw)
        tc = TSM.SparseInferConfig(**dataclasses.asdict(jc))
        assert TDD.semantic_grid(tc) == JDD.semantic_grid(jc)
        assert TDD.shard_caps(tc, K) == JDD.shard_caps(jc, K)
    rng = np.random.default_rng(0)
    dens, union = rng.random((3, 4)), rng.random((3, 4))
    assert list(TDD.shard_gauge_rows(dens, union)) == \
        list(JDD.shard_gauge_rows(dens, union))
    assert list(TDD.shard_gauge_rows(dens)) == \
        list(JDD.shard_gauge_rows(dens))


def test_rejections():
    """Grouped (G, B, d) input, a batch the data shards do not divide, and
    int8 leaves whose quant groups do not split over the shards."""
    jp, tp = _mlp_params(0, False)
    _, tc = _sparse_cfgs("gather", 1, 2)
    with pytest.raises(ValueError, match="tp_shards"):
        TDD.sharded_apply(tp, torch.zeros(2, 3, D), tc, 1.0,
                          strategy="gather")
    _, tc = _sparse_cfgs("gather", 3, 2)
    with pytest.raises(ValueError, match="dp_shards"):
        TSM.apply(tp, torch.zeros(4, D), tc, alpha=1.0)
    _, tq = _mlp_params(0, True)
    _, tc = _sparse_cfgs("pallas", 1, 8)          # 64 rows: 4 quant groups
    tq = dict(tq, wd_s=tq["wd_s"][:3])            # 48 rows' worth
    with pytest.raises(ValueError, match="split"):
        TSM.apply(tq, torch.zeros(4, D), tc, alpha=1.0)


def test_dense_fallback_emits_zero_riders():
    """A decode batch past ``sparse_max_batch`` runs dense and still emits
    the riders, as the reference's ``mlp_apply`` does, so its stats stack
    against the sharded layers'."""
    _, tp = _mlp_params(0, False)
    _, tc = _sparse_cfgs("gather", 1, 4)
    x = torch.from_numpy(_x(3, tc.sparse_max_batch + 4))
    _, st = mlp_apply(tp, x, tc, decode=True, alpha=1.0, return_stats=True)
    assert st[TSM.SHARD_STAT_KEY].shape == (tc.sparse_max_batch + 4, 4)
    assert not st[TSM.SHARD_STAT_KEY].any()
    assert TSM.zero_mlp_stats((3,), tp_shards=2)[
        TSM.SHARD_UNION_KEY].shape == (3, 2)


# ----------------------------------------------------------- grid checks --

_SHARDABLE_CASES = [
    # (config fields, k, ms)
    ({"capacity_frac": 0.5}, K, 4),
    ({"group_size": 1, "capacity_override": 130}, K, 4),
    ({}, K + 8, 4),
    ({"group_size": 1, "capacity_buckets": (0.1, 0.5)}, 512, 4),
    ({"group_size": 1, "capacity_buckets": (0.1, 0.3)}, 512, 4),
    ({"weight_dtype": "int8", "quant_group_size": 128}, 1024, 4),
    ({"weight_dtype": "int8", "quant_group_size": 128}, 1024, 16),
    ({"weight_dtype": "int8", "quant_group_size": 128}, 11008, 2),
    ({"weight_dtype": "int8", "quant_group_size": 128}, 11008, 4),
    ({"capacity_buckets": (0.1, 0.2, 0.4)}, 11008, 2),
    ({"capacity_buckets": (0.1, 0.2, 0.4)}, 11008, 4),
    ({"shard_bucket_caps": (4, 8)}, K, 2),
    ({"shard_bucket_caps": (4, 8, 8)}, K, 2),
    ({"shard_bucket_caps": (0, 8)}, K, 2),
    ({"shard_bucket_caps": (4, 40)}, K, 2),
    ({}, K, 1),
]


def _outcome(fn):
    try:
        return fn()
    except ValueError:
        return "ValueError"


@pytest.mark.parametrize("fields,k,ms", _SHARDABLE_CASES)
def test_validate_shardable_and_shard_capacity_match_reference(fields, k,
                                                               ms):
    """The port accepts and rejects what the reference does, and
    ``shard_capacity`` gives the reference's width."""
    jc = JSM.SparseInferConfig(**fields)
    tc = TSM.SparseInferConfig(**dataclasses.asdict(jc))
    assert _outcome(lambda: TSS.validate_shardable(tc, k, ms)) == \
        _outcome(lambda: JSS.validate_shardable(jc, k, ms))
    jcs = dataclasses.replace(jc, tp_shards=ms)
    tcs = dataclasses.replace(tc, tp_shards=ms)
    assert _outcome(lambda: tcs.shard_capacity(k)) == \
        _outcome(lambda: jcs.shard_capacity(k))


def test_resolve_grid():
    tc = TSM.SparseInferConfig(tp_shards=2, dp_shards=2)
    assert TSS.resolve_grid(tc, 4) == (2, 2)
    assert TSS.resolve_grid(TSM.SparseInferConfig(), 3) == (1, 1)
    with pytest.raises(ValueError, match="dp_shards"):
        TSS.resolve_grid(tc, 3)


# -------------------------------------------------------- the controller --

@pytest.mark.parametrize("ms_old,ms_new", [(2, 2), (2, 3), (4, 2), (3, 4),
                                           (1, 4), (4, 1)])
def test_remap_shard_ema_matches_reference(ms_old, ms_new):
    ema = np.random.default_rng(ms_old * 7 + ms_new).random(
        (5, ms_old)).astype(np.float32)
    got = tctl.remap_shard_ema(ema, ms_new)
    np.testing.assert_array_equal(got, jctl.remap_shard_ema(ema, ms_new))
    np.testing.assert_allclose(got.mean(-1), ema.mean(-1), rtol=1e-6)


def _ctl_pair(ms: int, ds: int, tiered: bool):
    ccfg = dict(enabled=True, target_density=0.3, gain=0.7, ema=0.3,
                audit_period=4, fn_budget=0.05, shard_slack=1.2)
    jc = jctl.DistributedController(jctl.AlphaController(
        JControllerConfig(**ccfg), JAlphaSchedule(), 4,
        tiers=J_TIERS if tiered else None), ms, n_data_shards=ds)
    tc = tctl.DistributedController(tctl.AlphaController(
        ControllerConfig(**ccfg), AlphaSchedule(), 4,
        tiers=DEFAULT_SLA_TIERS if tiered else None), ms, n_data_shards=ds)
    return jc, tc


def _assert_ctl_equal(jc, tc, k=11008):
    for name in ("shard_density_ema", "shard_union_ema"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name),
                                      err_msg=name)
    assert tc._shard_steps == jc._shard_steps
    np.testing.assert_array_equal(tc.shard_capacity_hints(k),
                                  jc.shard_capacity_hints(k))
    assert tc.shard_skew() == jc.shard_skew()
    assert tc.report() == jc.report()
    np.testing.assert_array_equal(tc.alphas(), jc.alphas())


@pytest.mark.parametrize("tiered", [False, True])
def test_distributed_controller_step_by_step(tiered):
    """60 steps of random stats with riders (L, B, 2), random live slots
    (none live in some steps) and audit steps that only strip: the shard
    EMAs, hints, skew and report equal the reference's after every step;
    the gauges it publishes equal; a snapshot restores, and one of another
    grid is remapped with a warning, as the reference's."""
    jc, tc = _ctl_pair(2, 2, tiered)
    rng = np.random.default_rng(4)
    L, b = 4, 6
    for step in range(60):
        audit = jc.is_audit_step()
        assert tc.is_audit_step() == audit
        stats = {k: rng.random((L, b)).astype(np.float32)
                 for k in TSM.MLP_STAT_KEYS}
        for k in TSM.SHARD_RIDER_KEYS:
            stats[k] = rng.random((L, b, 2)).astype(np.float32)
        active = rng.random(b) < (0.0 if step % 13 == 5 else 0.7)
        rest_j = jc.consume_shard_stats(stats, active, fold=not audit)
        rest_t = tc.consume_shard_stats(stats, active, fold=not audit)
        assert set(rest_t) == set(rest_j) == set(TSM.MLP_STAT_KEYS)
        tier_idx = rng.integers(0, 3, size=b)
        if tiered:
            agg, cnt = jctl.aggregate_tier_stats(rest_j, tier_idx, 3, active)
            jc.observe(agg, audit=audit, tier_counts=cnt)
            tc.observe(agg, audit=audit, tier_counts=cnt)
        elif active.any():
            obs = {k: v[:, active].mean(-1) for k, v in rest_j.items()}
            jc.observe(obs, audit=audit)
            tc.observe(obs, audit=audit)
        _assert_ctl_equal(jc, tc)
    with pytest.raises(ValueError, match="shape"):
        tc.consume_shard_stats({TSM.SHARD_STAT_KEY: np.zeros((L, b, 3))})
    jhub, thub = (jmetrics.MetricsHub(JMetricsConfig(enabled=True)),
                  tmetrics.MetricsHub(MetricsConfig(enabled=True)))
    jc.publish_metrics(jhub)
    tc.publish_metrics(thub)
    assert thub.snapshot()["gauges"] == jhub.snapshot()["gauges"]
    assert thub.gauge_value("shard_union_demand", layer=3, shard=1) == \
        float(tc.shard_union_ema[3, 1])
    tree, meta = jc.state_dict()
    t_tree, t_meta = tc.state_dict()
    assert t_meta == meta
    for k in tree:
        np.testing.assert_array_equal(t_tree[k], tree[k], err_msg=k)
    jc4, tc4 = _ctl_pair(4, 1, tiered)
    for c, snap in ((jc4, (tree, meta)), (tc4, (t_tree, t_meta))):
        with pytest.warns(UserWarning, match="remapped"):
            c.load_state_dict(*snap)
    _assert_ctl_equal(jc4, tc4)
    assert tc4.stats_regrids == jc4.stats_regrids == 1
    bad = dict(t_tree, shard_density_ema=np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="shape"):
        tc4.load_state_dict(bad, t_meta)


# ----------------------------------------------------------- model level --

def _model_cfgs(strategy: str, ds: int, ms: int, buckets=(), weights="",
                d_ff=512, **sparse_kw):
    out = []
    for reduced in (j_reduced, t_reduced):
        cfg = reduced(ARCH)
        out.append(cfg.replace(d_ff=d_ff, sparse=dataclasses.replace(
            cfg.sparse, strategy=strategy, capacity_frac=0.5,
            capacity_buckets=buckets, sparse_prefill=True,
            tp_shards=ms if ms > 1 else 0, dp_shards=ds if ds > 1 else 0,
            weight_dtype=weights, quant_group_size=32, **sparse_kw)))
    return out


@functools.lru_cache(maxsize=None)
def _lm_params():
    jcfg, tcfg = _model_cfgs("gather", 1, 1)
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    return jparams, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


@pytest.mark.parametrize("strategy,ds,ms,weights", [
    ("pallas", 2, 2, ""), ("gather", 1, 4, ""), ("masked", 2, 2, ""),
    ("pallas", 1, 2, "int8"), ("gather", 2, 1, "")])
def test_decode_step_teacher_forced(strategy, ds, ms, weights):
    """A 10-token prefill (dense, as the reference keeps a sharded prefill)
    and 4 teacher-forced decode steps at per-slot alphas with a dead slot:
    logits within 1e-4, the (L, B) stats and (L, B, ms) riders equal."""
    jcfg, tcfg = _model_cfgs(strategy, ds, ms, weights=weights)
    jp0, tp0 = _lm_params()
    jp, tp = jlm.prepare_sparse(jp0, jcfg.sparse), \
        tlm.prepare_sparse(tp0, tcfg.sparse)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, jcfg.vocab, size=(B, 10))
    forced = rng.integers(0, jcfg.vocab, size=(4, B, 1))
    alphas = (jcfg.sparse.alpha_schedule().alphas(jcfg.n_layers)[:, None]
              + np.asarray([0.0, 0.25, -0.25, 0.1], np.float32)[None, :])
    alphas[:, 2] = DEAD
    jstep = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg,
                                      collect_stats=True))
    _, jcache = jlm.prefill(jp, jcfg, jnp.asarray(prompt), 32)
    with torch.inference_mode():
        _, tcache = tlm.prefill(tp, tcfg, torch.from_numpy(prompt), 32)
    for t in range(4):
        lens = np.full(B, 10 + t, np.int32)
        jl, jcache, jst = jstep(jp, token=jnp.asarray(forced[t]),
                                caches=jcache, cache_len=jnp.asarray(lens),
                                alphas=jnp.asarray(alphas))
        with torch.inference_mode():
            tl, tcache, tst = tlm.decode_step(
                tp, tcfg, torch.from_numpy(forced[t]), tcache,
                torch.from_numpy(lens), alphas=alphas, collect_stats=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4, err_msg=f"step {t}")
        _same_stats({k: v.numpy() for k, v in tst.items()},
                    {k: np.asarray(v) for k, v in jst.items()},
                    f"step {t}")
        if ms > 1:
            assert tst[TSM.SHARD_STAT_KEY].shape == (jcfg.n_layers, B, ms)


def test_prefill_chunk_stats_carry_zero_riders():
    """A sharded config's chunked prefill runs dense: its stats, with the
    zero riders (L, B, ms), equal the reference's."""
    jcfg, tcfg = _model_cfgs("pallas", 2, 2)
    jp0, tp0 = _lm_params()
    jp, tp = jlm.prepare_sparse(jp0), tlm.prepare_sparse(tp0)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, size=(2, 8))
    jcache = jlm.init_caches(jcfg, 2, 16)
    tcache = tlm.init_caches(tcfg, 2, 16, device="cpu")
    jl, _, jst = jlm.prefill_chunk(jp, jcfg, jnp.asarray(toks), jcache, 0,
                                   jnp.asarray([5, 8]), collect_stats=True)
    with torch.inference_mode():
        tl, _, tst = tlm.prefill_chunk(tp, tcfg, torch.from_numpy(toks),
                                       tcache, 0, torch.tensor([5, 8]),
                                       collect_stats=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    _same_stats({k: v.numpy() for k, v in tst.items()},
                {k: np.asarray(v) for k, v in jst.items()}, "chunk")
    assert tst[TSM.SHARD_UNION_KEY].shape == (jcfg.n_layers, 2, 2)


# ----------------------------------------------------------------- server --

def _requests(seed: int, n: int, vocab: int, slas, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab,
                                               size=int(rng.integers(5, 21))),
                    max_new=int(rng.integers(5, 10)), sla=slas[i % len(slas)])
            for i in range(n)]


def _close(a, b, path=""):
    """Reports equal: ints, bools and strings exactly, floats to 1e-5."""
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(b, float):
        assert abs(a - b) <= 1e-5, (path, a, b)
    else:
        assert a == b, (path, a, b)


_CCFG = dict(enabled=True, target_density=0.2, gain=1.0, ema=0.5,
             audit_period=4, fn_budget=0.5)


def _servers(jcfg, tcfg, per_tier=True, paged=False, warm=False,
             watchdog=False, **ccfg_kw):
    jp0, tp0 = _lm_params()
    ccfg = dict(_CCFG, per_tier=per_tier, **ccfg_kw)
    kw = dict(batch=B, max_len=64, warm_buckets=warm)
    if paged:
        kw.update(prefill_chunk=8, prefill_interleave=2)
    jkw, tkw = dict(kw), dict(kw)
    if paged:
        jkw["paged_kv"] = JPagedKVConfig(block_size=8)
        tkw["paged_kv"] = PagedKVConfig(block_size=8)
    jsrv = jserver.Server(jlm, jcfg, jserver.ServeConfig(
        controller=JControllerConfig(**ccfg),
        metrics=JMetricsConfig(enabled=True, watchdog=watchdog), **jkw), jp0)
    tsrv = Server(tlm, tcfg, ServeConfig(
        controller=ControllerConfig(**ccfg),
        metrics=MetricsConfig(enabled=True, watchdog=watchdog), **tkw), tp0,
        device="cpu")
    return jsrv, tsrv


@pytest.mark.parametrize("strategy,per_tier,buckets,ds,ms,paged", [
    ("pallas", True, (0.25, 0.5, 1.0), 2, 2, False),
    ("pallas", False, (0.25, 0.5, 1.0), 1, 2, True),
    ("gather", True, (0.25, 0.5, 1.0), 2, 2, True),
    ("gather", True, (), 1, 4, False),
    ("masked", True, (), 2, 2, True)])
def test_server_matches_reference(strategy, per_tier, buckets, ds, ms,
                                  paged):
    """The controller-driven server with a sharded config against the JAX
    server with no mesh, on 6 requests of mixed tiers (gather: a masked
    audit every 4th step; paged: chunked prefill on a pool of blocks of 8,
    dense under sharding, so no prefill rider): tokens, the controller's
    report with ``shard_skew``, the bucket-tuple sequence, ``paged_stats``
    and every gauge (per-shard buckets and shard EMAs among them) equal."""
    jcfg, tcfg = _model_cfgs(strategy, ds, ms, buckets)
    jsrv, tsrv = _servers(jcfg, tcfg, per_tier, paged)
    assert isinstance(tsrv.controller, tctl.DistributedController) == \
        (ms > 1)
    j_buckets = []
    select = jsrv._select_bucket

    def recording_select():
        j_buckets.append(select())
        return j_buckets[-1]
    jsrv._select_bucket = recording_select
    slas = ("latency", "balanced", "quality")
    jdone = jsrv.serve(_requests(3, 6, jcfg.vocab, slas, jserver.Request))
    tdone = tsrv.serve(_requests(3, 6, tcfg.vocab, slas))
    for jr, tr in zip(sorted(jdone, key=lambda r: r.uid),
                      sorted(tdone, key=lambda r: r.uid)):
        np.testing.assert_array_equal(tr.out, jr.out, err_msg=f"uid {tr.uid}")
    jrep, trep = jsrv.controller.report(), tsrv.controller.report()
    _close(trep, jrep)
    assert trep["audits"] == (0 if strategy == "pallas"
                              else trep["steps"] // 4)
    assert trep["prefill_chunks"] == 0
    if ms > 1:
        assert trep["n_shards"] == ms and "shard_skew" in trep
    assert list(tsrv.bucket_history) == j_buckets
    if buckets:
        assert all(isinstance(t, tuple) and len(t) == ms for t in j_buckets)
        assert len(set(j_buckets)) > 1
    assert tsrv.paged_stats() == jsrv.paged_stats()
    jg, tg = jsrv.metrics.snapshot()["gauges"], \
        tsrv.metrics.snapshot()["gauges"]
    _close(tg, jg)
    if buckets and ms > 1:
        assert 'capacity_bucket_groups{shard="1"}' in tg
        assert 'shard_union_demand{layer="1",shard="1"}' in tg


def test_tuple_ladder_and_uniform_fallback():
    """ms=2 over a 3-rung ladder: all 9 bucket tuples, as the reference's
    server builds; ms=4 needs 81 > bucket_tuple_cap=16 and falls back to
    the 3 uniform tuples with the reference's warning.  A forced skewed
    union demand picks the reference's heterogeneous tuple."""
    buckets = (0.25, 0.5, 1.0)
    jcfg, tcfg = _model_cfgs("pallas", 2, 2, buckets)
    jsrv, tsrv = _servers(jcfg, tcfg)
    assert set(tsrv._bucket_cfgs) == set(jsrv._bucket_fns)
    assert len(tsrv._bucket_cfgs) == 9 and tsrv._per_shard_buckets
    assert tsrv._active_cap == jsrv._active_cap == (32, 32)
    for srv, req in ((jsrv, jserver.Request), (tsrv, Request)):
        srv.serve(_requests(1, 2, jcfg.vocab, ("balanced",), req))
        srv.controller.shard_union_ema = np.array(
            [[0.05, 0.9]] * jcfg.n_layers, np.float32)
    assert tsrv._select_bucket() == jsrv._select_bucket() == (8, 32)
    jcfg4, tcfg4 = _model_cfgs("gather", 1, 4, buckets)
    with pytest.warns(UserWarning, match="bucket_tuple_cap"):
        jsrv4, tsrv4 = _servers(jcfg4, tcfg4)
    assert set(tsrv4._bucket_cfgs) == set(jsrv4._bucket_fns) == \
        {(4, 4, 4, 4), (8, 8, 8, 8), (16, 16, 16, 16)}
    assert not tsrv4._per_shard_buckets


def test_no_first_use_after_warmup():
    """warm_buckets runs all 9 tuples once before the first controller
    step: every tuple is set up exactly once, the tokens equal an unwarmed
    server's, and the watchdog armed by the first drain counts no first
    use in a second serve."""
    buckets = (0.25, 0.5, 1.0)
    _, tcfg = _model_cfgs("pallas", 2, 2, buckets)
    out = []
    for warm in (False, True):
        _, tsrv = _servers(*_model_cfgs("pallas", 2, 2, buckets), warm=warm,
                           watchdog=warm)
        done = tsrv.serve(_requests(4, 4, tcfg.vocab, ("balanced",)))
        out.append({r.uid: r.out.tolist() for r in done})
    assert out[0] == out[1]
    assert tsrv.warmup_steps == 9
    assert dict(tsrv._trace_counts) == dict.fromkeys(tsrv._bucket_cfgs, 1)
    tsrv.controller.shard_union_ema = np.array(
        [[0.05, 0.9]] * tcfg.n_layers, np.float32)
    tsrv.serve(_requests(5, 3, tcfg.vocab, ("balanced",)))
    assert dict(tsrv._trace_counts) == dict.fromkeys(tsrv._bucket_cfgs, 1)
    assert tsrv.metrics_report()["watchdog"]["retraces_post_warmup"] == 0
    tsrv.metrics.watchdog.uninstall()


def test_server_construction_checks(monkeypatch):
    """int8 weights whose quant groups do not split over the shards, a
    batch the data shards do not divide, and a shard shape the kernels'
    plans refuse: each raises at construction, as a decode step would have
    nothing to fall back to."""
    _, tp0 = _lm_params()
    _, tcfg = _model_cfgs("pallas", 1, 8, weights="int8")   # 64 rows, qg 32
    tcfg = tcfg.replace(sparse=dataclasses.replace(tcfg.sparse,
                                                   quant_group_size=128))
    with pytest.raises(ValueError, match="quant_group_size"):
        Server(tlm, tcfg, ServeConfig(batch=B, max_len=32), tp0,
               device="cpu")
    _, tcfg = _model_cfgs("pallas", 3, 2)
    with pytest.raises(ValueError, match="dp_shards"):
        Server(tlm, tcfg, ServeConfig(batch=B, max_len=32), tp0,
               device="cpu")

    def refuse(*a, **kw):
        raise ValueError("forced refusal")
    monkeypatch.setattr(KF, "decode_plan", refuse)
    _, tcfg = _model_cfgs("pallas", 2, 2)
    with pytest.raises(ValueError, match="shard 0 at bucket"):
        Server(tlm, tcfg, ServeConfig(batch=B, max_len=32), tp0,
               device="cpu")
    _, tcfg = _model_cfgs("gather", 2, 2)
    Server(tlm, tcfg, ServeConfig(batch=B, max_len=32), tp0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Server(tlm, tcfg, ServeConfig(batch=B, max_len=32), tp0,
               device="cpu")


def test_adapt_capacity_keeps_shard_grid():
    """Without a ladder, ``adapt_capacity`` moves a sharded config's static
    capacity at refill boundaries as the reference's server does (ms=2,
    ds=2; every aligned capacity splits over the two shards)."""
    caps = []
    jp0, tp0 = _lm_params()
    for (cfg, params, mk_ctl, mk_scfg, mk_srv, mk_req) in (
            (_model_cfgs("gather", 2, 2)[0], jp0, JControllerConfig,
             jserver.ServeConfig,
             lambda c, s, p: jserver.Server(jlm, c, s, p), jserver.Request),
            (_model_cfgs("gather", 2, 2)[1], tp0, ControllerConfig,
             ServeConfig,
             lambda c, s, p: Server(tlm, c, s, p, device="cpu"), Request)):
        cfg = cfg.replace(sparse=dataclasses.replace(
            cfg.sparse, capacity_frac=1.0, group_size=1,
            sparse_prefill=False))
        live = mk_ctl(enabled=True, target_density=0.1, gain=1.0, ema=0.5,
                      audit_period=0, fn_budget=1.0, adapt_capacity=True)
        srv = mk_srv(cfg, mk_scfg(batch=B, max_len=48, controller=live),
                     params)
        cap0 = srv.cfg.sparse.shard_capacity(cfg.d_ff)
        rng = np.random.default_rng(5)
        srv.serve([mk_req(uid=i, prompt=rng.integers(0, cfg.vocab, size=6),
                          max_new=12) for i in range(6)])
        caps.append((cap0, srv.cfg.sparse.shard_capacity(cfg.d_ff)))
    assert caps[0] == caps[1] and caps[1][1] < caps[1][0]


def test_generate_matches_reference():
    """``generate()`` (one fixed batch on the balanced tier) with a sharded
    config, the per-shard ladder and masked audits: tokens, the bucket
    sequence and the shard EMAs equal the JAX server's."""
    jcfg, tcfg = _model_cfgs("gather", 2, 2, (0.25, 0.5, 1.0))
    jsrv, tsrv = _servers(jcfg, tcfg, per_tier=True)
    j_buckets = []
    select = jsrv._select_bucket

    def recording_select():
        j_buckets.append(select())
        return j_buckets[-1]
    jsrv._select_bucket = recording_select
    prompts = np.random.default_rng(6).integers(0, jcfg.vocab, size=(B, 8))
    np.testing.assert_array_equal(tsrv.generate(prompts, 8),
                                  jsrv.generate(prompts, 8))
    assert list(tsrv.bucket_history) == j_buckets
    for name in ("shard_density_ema", "shard_union_ema"):
        np.testing.assert_allclose(getattr(tsrv.controller, name),
                                   getattr(jsrv.controller, name),
                                   rtol=0, atol=1e-6, err_msg=name)
