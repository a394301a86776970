"""The port's adaptive-alpha controller and the controller-driven server
against the reference's.

The controller is host numpy: fed the same stats it must hold the same
state bit for bit (alphas, EMAs, capacity hints, report, snapshot).  The
servers run reduced prosparse-llama2-7b in float32 with ``d_ff=512`` (64
row groups, so a capacity ladder of 16/32/64 groups has distinct rungs)
and chunked sparse prefill: tokens, audit counts and the bucket sequence
must be equal, the controller's report within 1e-5 (its inputs are integer
counts; only the logits differ, by float32 summation order).
"""
import dataclasses
import functools
import warnings

import jax
import numpy as np
import pytest

from repro.configs.base import ControllerConfig as JControllerConfig
from repro.configs.base import DEFAULT_SLA_TIERS as J_TIERS
from repro.configs.registry import reduced_config as j_reduced
from repro.core.predictor import AlphaSchedule as JAlphaSchedule
from repro.models import lm as jlm
from repro.runtime import controller as jctl
from repro.runtime import server as jserver
from repro_torch import bridge
from repro_torch.configs.base import DEFAULT_SLA_TIERS, ControllerConfig
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.core.predictor import AlphaSchedule
from repro_torch.core.sparse_mlp import MLP_STAT_KEYS
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lm
from repro_torch.runtime import controller as tctl
from repro_torch.runtime.server import Request, Server, ServeConfig

ARCH = "prosparse-llama2-7b"
L, B = 4, 5


def _random_stats(rng, shape) -> dict:
    return {k: rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
            for k in MLP_STAT_KEYS}


def _assert_state_equal(jc, tc):
    for name in ("alphas", "density_ema", "overflow_ema", "fn_ema",
                 "predicted_ema", "union_ema"):
        np.testing.assert_array_equal(getattr(tc.state, name),
                                      getattr(jc.state, name), err_msg=name)
    np.testing.assert_array_equal(tc.prefill_ema, jc.prefill_ema)
    assert (tc.state.steps, tc.state.audits, tc.prefill_chunks) == \
        (jc.state.steps, jc.state.audits, jc.prefill_chunks)


def test_configs_match_reference():
    assert [(f.name, f.default) for f in
            dataclasses.fields(ControllerConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JControllerConfig)]
    for tt, jt in zip(DEFAULT_SLA_TIERS, J_TIERS):
        for base in (0.0, 0.25, 0.9):
            assert tt.target(base) == jt.target(base)
    sched, jsched = AlphaSchedule(), JAlphaSchedule()
    np.testing.assert_array_equal(sched.init_state(7), jsched.init_state(7))


@pytest.mark.parametrize("tiered", [False, True])
@pytest.mark.parametrize("native_fn", [False, True])
def test_controller_bitwise_over_200_steps(tiered, native_fn):
    """Identical numpy stats over 200 steps, audits at period 4 (none with
    native_fn), a prefill observation every 7th step, frozen tiers when a
    tier has no live slot."""
    ccfg = dict(enabled=True, target_density=0.3, gain=0.7, ema=0.3,
                audit_period=4, fn_budget=0.05, prefill_weight=0.5)
    tiers = (DEFAULT_SLA_TIERS, J_TIERS) if tiered else (None, None)
    tc = tctl.AlphaController(ControllerConfig(**ccfg), AlphaSchedule(), L,
                              tiers=tiers[0], native_fn=native_fn)
    jc = jctl.AlphaController(JControllerConfig(**ccfg), JAlphaSchedule(), L,
                              tiers=tiers[1], native_fn=native_fn)
    rng = np.random.default_rng(0)
    for step in range(200):
        audit = jc.is_audit_step()
        assert tc.is_audit_step() == audit
        stats = _random_stats(rng, (L, B))
        if tiered:
            tier_idx = rng.integers(0, 3, size=B)
            active = rng.random(B) < 0.7
            agg_j, cnt_j = jctl.aggregate_tier_stats(stats, tier_idx, 3,
                                                     active)
            agg_t, cnt_t = tctl.aggregate_tier_stats(stats, tier_idx, 3,
                                                     active)
            np.testing.assert_array_equal(cnt_t, cnt_j)
            for k in agg_j:
                np.testing.assert_array_equal(agg_t[k], agg_j[k])
            jc.observe(agg_j, audit=audit, tier_counts=cnt_j)
            tc.observe(agg_t, audit=audit, tier_counts=cnt_t)
            np.testing.assert_array_equal(tc.slot_alphas(tier_idx),
                                          jc.slot_alphas(tier_idx))
        else:
            obs = {k: v.mean(-1) for k, v in stats.items()}
            jc.observe(obs, audit=audit)
            tc.observe(obs, audit=audit)
        if step % 7 == 3:
            pre = {k: v[:, 0] for k, v in _random_stats(rng, (L, 1)).items()}
            tier = int(rng.integers(0, 3)) if tiered else None
            jc.observe_prefill(pre, tier=tier)
            tc.observe_prefill(pre, tier=tier)
        _assert_state_equal(jc, tc)
        for k in (512, 11008):
            assert tc.capacity_hint(k) == jc.capacity_hint(k)
    assert jc.state.audits == (0 if native_fn else 50)
    assert tc.report() == jc.report()
    assert tc.trajectory == jc.trajectory
    assert tc.converged(0.05) == jc.converged(0.05)
    t_tree, t_meta = tc.state_dict()
    j_tree, j_meta = jc.state_dict()
    assert t_meta == j_meta
    for k in j_tree:
        np.testing.assert_array_equal(t_tree[k], j_tree[k])


def test_state_dict_round_trip_and_rejections():
    """A reference snapshot restores into the port's controller and both
    go on equal; another tier set, depth or native_fn mode is rejected."""
    ccfg = dict(enabled=True, target_density=0.2, audit_period=3)
    jc = jctl.AlphaController(JControllerConfig(**ccfg), JAlphaSchedule(), L,
                              tiers=J_TIERS)
    rng = np.random.default_rng(1)
    for _ in range(9):
        jc.observe(_random_stats(rng, (3, L)), audit=jc.is_audit_step())
    tc = tctl.AlphaController(ControllerConfig(**ccfg), AlphaSchedule(), L,
                              tiers=DEFAULT_SLA_TIERS)
    tc.load_state_dict(*jc.state_dict())
    _assert_state_equal(jc, tc)
    for _ in range(5):
        stats = _random_stats(rng, (3, L))
        audit = jc.is_audit_step()
        jc.observe(stats, audit=audit)
        tc.observe(stats, audit=audit)
    _assert_state_equal(jc, tc)
    tree, meta = tc.state_dict()
    for bad in (dict(meta, tiers=["balanced"]), dict(meta, num_layers=L + 1),
                dict(meta, native_fn=True)):
        with pytest.raises(ValueError, match="mismatch"):
            tctl.AlphaController(ControllerConfig(**ccfg), AlphaSchedule(),
                                 L, tiers=DEFAULT_SLA_TIERS
                                 ).load_state_dict(tree, bad)


# ------------------------------------------------------------- servers ----

def _model_cfgs(strategy: str, buckets=(), d_ff=512):
    out = []
    for reduced in (j_reduced, t_reduced):
        cfg = reduced(ARCH)
        out.append(cfg.replace(d_ff=d_ff, sparse=dataclasses.replace(
            cfg.sparse, strategy=strategy, capacity_frac=0.5,
            capacity_buckets=buckets, sparse_prefill=True)))
    return out


@functools.lru_cache(maxsize=None)
def _params(d_ff: int = 512):
    jcfg, tcfg = _model_cfgs("gather", d_ff=d_ff)
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    return jparams, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


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


@pytest.mark.parametrize("strategy,per_tier", [
    ("gather", True), ("gather", False), ("pallas", True),
    ("pallas", False)])
def test_server_with_controller_matches_reference(strategy, per_tier):
    """gather: masked audits every 4th step and a 3-rung capacity ladder;
    pallas: native false negatives, no audits.  Both with the prefill
    rider (chunks of 8, sparse prefill) and mixed tiers."""
    buckets = (0.25, 0.5, 1.0) if strategy == "gather" else ()
    jcfg, tcfg = _model_cfgs(strategy, buckets)
    jp, tp = _params()
    # fn_budget 0.5: the false-negative term (reduced dims mispredict
    # often) must not hold alpha up, or the union never leaves the top rung
    ccfg = dict(enabled=True, target_density=0.2, gain=1.0, ema=0.5,
                audit_period=4, fn_budget=0.5, per_tier=per_tier,
                prefill_weight=0.5)
    kw = dict(batch=2, max_len=64, prefill_chunk=8, prefill_interleave=2)
    jsrv = jserver.Server(jlm, jcfg, jserver.ServeConfig(
        controller=JControllerConfig(**ccfg), **kw), jp)
    tsrv = Server(lm, tcfg, ServeConfig(
        controller=ControllerConfig(**ccfg), **kw), tp, device="cpu")
    j_buckets = []
    select = jsrv._select_bucket

    def recording_select():
        j_buckets.append(select())
        return j_buckets[-1]
    jsrv._select_bucket = recording_select
    slas = ("latency", "balanced", "quality")
    jdone = jsrv.serve(_requests(3, 5, jcfg.vocab, slas, jserver.Request))
    tdone = tsrv.serve(_requests(3, 5, tcfg.vocab, slas))
    for jr, tr in zip(sorted(jdone, key=lambda r: r.uid),
                      sorted(tdone, key=lambda r: r.uid)):
        np.testing.assert_array_equal(tr.out, jr.out, err_msg=f"uid {tr.uid}")
    jrep, trep = jsrv.controller.report(), tsrv.controller.report()
    _close(trep, jrep)
    assert trep["audits"] == (0 if strategy == "pallas"
                              else trep["steps"] // 4)
    assert trep["prefill_chunks"] == tsrv.prefill_chunks_run > 0
    assert list(tsrv.bucket_history) == j_buckets
    if buckets:
        assert set(j_buckets) <= {16, 32, 64} and len(set(j_buckets)) > 1
    np.testing.assert_allclose(tsrv.controller.alphas(),
                               jsrv.controller.alphas(), rtol=0, atol=1e-5)


def test_frozen_controller_reproduces_static_tokens():
    """gain=0 and no audits: the controller's alpha plumbing emits the
    static schedule's tokens, and its alphas never leave the schedule."""
    _, tcfg = _model_cfgs("gather")
    _, tp = _params()
    prompts = np.random.default_rng(1).integers(0, tcfg.vocab, size=(2, 8))
    static = Server(lm, tcfg, ServeConfig(batch=2, max_len=48), tp,
                    device="cpu").generate(prompts, 8)
    frozen = ControllerConfig(enabled=True, gain=0.0, fn_gain=0.0,
                              audit_period=0)
    srv = Server(lm, tcfg, ServeConfig(batch=2, max_len=48,
                                       controller=frozen), tp, device="cpu")
    np.testing.assert_array_equal(srv.generate(prompts, 8), static)
    assert srv.controller.state.steps == 7
    np.testing.assert_array_equal(
        srv.controller.alphas(),
        tcfg.sparse.alpha_schedule().alphas(tcfg.n_layers))


def test_adapt_capacity_resizes_between_chunks():
    """Without a ladder, adapt_capacity shrinks an oversized capacity at
    refill boundaries from the controller's hint, as the reference's
    server does on the same queue."""
    caps = []
    for (cfg, params, mk_ctl, mk_scfg, mk_srv, mk_req) in (
            (_model_cfgs("gather")[0], _params()[0], JControllerConfig,
             jserver.ServeConfig,
             lambda c, s, p: jserver.Server(jlm, c, s, p), jserver.Request),
            (_model_cfgs("gather")[1], _params()[1], ControllerConfig,
             ServeConfig,
             lambda c, s, p: Server(lm, c, s, p, device="cpu"), Request)):
        cfg = cfg.replace(sparse=dataclasses.replace(
            cfg.sparse, capacity_frac=1.0, group_size=1,
            sparse_prefill=False))
        live = mk_ctl(enabled=True, target_density=0.1, gain=1.0, ema=0.5,
                      audit_period=0, fn_budget=1.0, adapt_capacity=True)
        srv = mk_srv(cfg, mk_scfg(batch=2, max_len=48, controller=live),
                     params)
        cap0 = srv.cfg.sparse.capacity(cfg.d_ff)
        rng = np.random.default_rng(5)
        srv.serve([mk_req(uid=i, prompt=rng.integers(0, cfg.vocab, size=6),
                          max_new=12) for i in range(4)])
        cap1 = srv.cfg.sparse.capacity(cfg.d_ff)
        assert cap1 < cap0
        caps.append((cap0, cap1))
    assert caps[0] == caps[1]


def test_bucket_ladder_warmup_and_no_setup_after():
    """warm_buckets runs every rung once (on copies of the caches: the
    tokens equal an unwarmed server's); after it no bucket is set up
    again, and reset() restores a fresh controller."""
    _, tcfg = _model_cfgs("gather", (0.25, 0.5, 1.0))
    _, tp = _params()
    ccfg = ControllerConfig(enabled=True, target_density=0.1, gain=1.0,
                            ema=0.5, audit_period=3, fn_budget=1.0)
    out = []
    for warm in (False, True):
        srv = Server(lm, tcfg, ServeConfig(batch=2, max_len=48,
                                           controller=ccfg,
                                           warm_buckets=warm), tp,
                     device="cpu")
        done = srv.serve(_requests(4, 4, tcfg.vocab, ("balanced",)))
        out.append({r.uid: r.out.tolist() for r in done})
        if warm:
            assert srv.warmup_steps == 3
            assert dict(srv._trace_counts) == {16: 1, 32: 1, 64: 1}
            assert len(set(srv.bucket_history)) > 1
            srv.serve(_requests(5, 3, tcfg.vocab, ("balanced",)))
            assert dict(srv._trace_counts) == {16: 1, 32: 1, 64: 1}
            srv.reset()
            assert srv.controller.state.steps == 0
            assert srv._active_cap == 64 and not srv.bucket_history
    assert out[0] == out[1]


def test_bucket_warnings():
    _, tcfg = _model_cfgs("gather", (0.25, 0.5))
    _, tp = _params()
    with pytest.warns(UserWarning, match="controller is disabled"):
        Server(lm, tcfg, ServeConfig(batch=2, max_len=32), tp, device="cpu")
    masked = tcfg.replace(sparse=dataclasses.replace(tcfg.sparse,
                                                     strategy="masked"))
    with pytest.warns(UserWarning, match="no capacity selection"):
        srv = Server(lm, masked, ServeConfig(
            batch=2, max_len=32, controller=ControllerConfig(enabled=True)),
            tp, device="cpu")
    assert srv._bucket_cfgs.keys() == {0}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Server(lm, tcfg, ServeConfig(
            batch=2, max_len=32, controller=ControllerConfig(enabled=True)),
            tp, device="cpu")


def test_serve_cli_controller_report():
    rep = serve_cli.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--strategy",
        "gather", "--controller", "--per-tier", "--audit-period", "4",
        "--capacity-buckets", "0.5,1.0", "--warm-buckets",
        "--requests", "3", "--batch", "2", "--max-new", "6",
        "--sla-mix", "latency:1,balanced:1,quality:1"])
    ctl = rep["controller"]
    assert rep["completed"] == 3 and ctl["steps"] > 0
    assert ctl["audits"] == ctl["steps"] // 4
    assert set(ctl["tiers"]) == {"latency", "balanced", "quality"}
    assert rep["sparse"]["capacity_buckets"] == [16]
