"""The port's overload handling against the JAX server, on the CPU.

Both servers get the tiny paged config of ``test_torch_paged_kv.py`` with
the masked strategy (its decode is exact per slot, so a survivor's tokens
do not depend on who shared its batch), the same weights (through the
port's bridge), the same requests and a ``FaultInjector(seed,
virtual_clock=True)`` each, with the settings of ``tests/test_chaos.py``'s
``chaos_scfg``.  On the virtual clock every overload decision is a
function of scheduling alone, so the two must agree exactly: each
request's outcome, shed reason, preemption count, tokens and time stamps,
``paged_stats()``, ``throughput_report``.  Each scenario
also checks what the reference's chaos test checks of its own server: the
pool's invariants, and survivors bitwise an unpressured run.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs.base import PagedKVConfig as JPagedKVConfig
from repro.models import lm as jlm
from repro.runtime import faults as jfaults
from repro.runtime import kv_pool as jkv
from repro.runtime import server as jserver
from repro_torch.configs.base import PagedKVConfig
from repro_torch.models import lm
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import kv_pool as tkv
from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                        throughput_report)
from test_torch_paged_kv import _tiny, _tiny_params

PLENS = (17, 21, 19, 23, 15, 22)
SLAS = ("latency", "quality", "balanced", "quality", "balanced", "latency")


def chaos_scfgs(pool_blocks, **kw):
    """``tests/test_chaos.py:chaos_scfg`` in both packages."""
    kw.setdefault("preempt", True)
    kw.setdefault("default_deadline_s", 100.0)
    kw.setdefault("prefill_interleave", 8)
    return (jserver.ServeConfig(batch=2, max_len=64,
                                paged_kv=JPagedKVConfig(
                                    block_size=8, pool_blocks=pool_blocks),
                                **kw),
            ServeConfig(batch=2, max_len=64,
                        paged_kv=PagedKVConfig(block_size=8,
                                               pool_blocks=pool_blocks),
                        **kw))


def servers(pool_blocks, **kw):
    jcfg, tcfg = _tiny("masked")
    jp, tp = _tiny_params("masked")
    jsc, tsc = chaos_scfgs(pool_blocks, **kw)
    return (jserver.Server(jlm, jcfg, jsc, jp),
            Server(lm, tcfg, tsc, tp, device="cpu"))


def specs_default(max_new=6):
    """(uid, prompt, max_new, sla, deadline_s) of the chaos queue."""
    rng = np.random.default_rng(0)
    return [(i, rng.integers(0, 128, size=p), max_new, SLAS[i], 0.0)
            for i, p in enumerate(PLENS)]


def specs_pressure(third_plen):
    """Two long latency-tier requests and a quality one with a tight
    deadline: the deadline-pressure cases of the reference's chaos test."""
    rng = np.random.default_rng(0)
    return [(0, rng.integers(0, 128, 17), 40, "latency", 0.0),
            (1, rng.integers(0, 128, 15), 40, "latency", 0.0),
            (2, rng.integers(0, 128, third_plen),
             8 if third_plen == 33 else 12, "quality", 1.2)]


def requests(specs, R):
    return [R(uid=u, prompt=p, max_new=m, sla=s, deadline_s=d)
            for u, p, m, s, d in specs]


def record(done):
    return {r.uid: (r.outcome, r.shed_reason, r.preemptions,
                    np.asarray(r.out).tolist(), r.t_admit, r.t_start,
                    r.t_end, r.latency_s, r.ttft_s, r.queue_wait_s,
                    r.deadline_s, r.sla)
            for r in done}


def assert_same(jdone, tdone, jsrv, tsrv):
    assert len(tdone) == len(jdone)
    assert record(tdone) == record(jdone)
    assert [r.uid for r in tdone] == [r.uid for r in jdone]
    # on the virtual clock the stamps are equal, so the whole report is:
    # the overload counts, the window, tok/s and every percentile
    assert throughput_report(tdone) == jserver.throughput_report(jdone)
    assert tsrv.paged_stats() == jsrv.paged_stats()
    assert (tsrv.preempt_count, tsrv.shed_count, tsrv.admissions_deferred) \
        == (jsrv.preempt_count, jsrv.shed_count, jsrv.admissions_deferred)
    jsrv.kv_pool.check_invariants()
    tsrv.kv_pool.check_invariants()


def assert_terminal(done, n):
    assert len(done) == n
    assert all(r.outcome in ("completed", "shed") for r in done)
    assert all(r.shed_reason for r in done if r.outcome == "shed")


def assert_survivors(done, want):
    for r in done:
        if r.outcome == "completed":
            np.testing.assert_array_equal(np.asarray(r.out), want[r.uid],
                                          err_msg=f"uid {r.uid}")


def outs(done):
    return {r.uid: np.asarray(r.out) for r in done}


def run_pair(pool_blocks, specs, *, seed=0, tick_s=0.01, arms=(), hold=0,
             **kw):
    """Serve ``specs`` on both servers; returns both (server, injector,
    done) triples after checking they agree."""
    out = []
    for srv, F, R in zip(servers(pool_blocks, **kw), (jfaults, tfaults),
                         (jserver.Request, Request)):
        fi = F.FaultInjector(seed=seed, virtual_clock=True, tick_s=tick_s)
        srv.attach_faults(fi)
        for a in arms:
            fi.arm(**a)
        if hold:
            n = (srv.kv_pool.n_blocks - 2 if hold == "all"
                 else srv.kv_pool.n_blocks - 2 - hold)
            assert fi.hold_blocks(srv.kv_pool, n) == n
        out.append((srv, fi, srv.serve(requests(specs, R))))
    (jsrv, jfi, jdone), (tsrv, tfi, tdone) = out
    assert_same(jdone, tdone, jsrv, tsrv)
    assert tfi.fired == jfi.fired
    return out


@pytest.fixture(scope="module")
def baseline():
    """The port's unpressured tokens of the chaos queue (pool auto-sized,
    no preemption, no deadlines), equal to the JAX server's."""
    (_, _, jdone), (_, _, tdone) = run_pair(
        0, specs_default(), preempt=False,
        default_deadline_s=0.0)
    assert all(r.outcome == "completed" for r in tdone)
    return outs(tdone)


@pytest.fixture(scope="module")
def pressure_refs():
    """Unpressured tokens of the two deadline-pressure queues."""
    refs = {}
    for plen, kw in ((23, {}), (33, dict(prefill_chunk=8,
                                          prefill_interleave=2))):
        specs = [(u, p, m, s, 0.0) for u, p, m, s, _ in specs_pressure(plen)]
        pool = 0 if plen == 23 else 24
        (_, _, _), (_, _, tdone) = run_pair(pool, specs, **kw)
        refs[plen] = outs(tdone)
    return refs


# ------------------------------------------------------------ scenarios ---

SCENARIOS = {
    # a 2x oversubscribed pool: ~18 blocks of demand, 7 allocatable
    "oversubscribed": dict(pool_blocks=8),
    "oversubscribed_chunked": dict(pool_blocks=8, prefill_chunk=8,
                                   prefill_interleave=2),
    "hold_partial": dict(pool_blocks=0, hold=7),
    "hold_total": dict(pool_blocks=0, hold="all"),
    "tight_deadlines": dict(pool_blocks=0, tick_s=0.05,
                            deadlines={1: 0.02, 3: 0.02, 5: 0.02}),
    "default_deadline": dict(pool_blocks=0, tick_s=1.0,
                             default_deadline_s=0.01),
    "prefill_fault": dict(pool_blocks=0,
                          arms=(dict(point="prefill", uid=2, times=1),)),
    "chunked_prefill_fault": dict(
        pool_blocks=0, prefill_chunk=8, prefill_interleave=2,
        arms=(dict(point="prefill", uid=3, after=1, times=1),)),
    "queue_depth": dict(pool_blocks=0, max_queue_depth=3),
    "pressure_gate": dict(pool_blocks=9, pressure_gate=0.4),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name, baseline):
    kw = dict(SCENARIOS[name])
    pool = kw.pop("pool_blocks")
    deadlines = kw.pop("deadlines", {})
    specs = [(u, p, m, s, deadlines.get(u, d))
             for u, p, m, s, d in specs_default()]
    (jsrv, _, jdone), (tsrv, tfi, tdone) = run_pair(pool, specs, **kw)
    assert_terminal(tdone, len(PLENS))
    assert_survivors(tdone, baseline)
    by = {r.uid: r for r in tdone}
    rep = throughput_report(tdone)
    if name.startswith("oversubscribed"):
        assert rep["preemptions"] >= 1 and rep["completed"] >= 1
    elif name == "hold_total":
        assert all(r.outcome == "shed" and r.shed_reason == "pool"
                   for r in tdone)
    elif name == "tight_deadlines":
        shed = {r.uid for r in tdone if r.outcome == "shed"}
        assert shed and shed <= set(deadlines)
        assert all(r.shed_reason == "deadline" and r.t_end == 0.0
                   for r in tdone if r.outcome == "shed")
    elif name == "default_deadline":
        assert any(r.shed_reason == "deadline" for r in tdone)
        assert all(r.deadline_s == 0.01 for r in tdone)
    elif name == "prefill_fault":
        assert (by[2].outcome, by[2].shed_reason) == ("shed", "fault")
        assert all(r.outcome == "completed" for u, r in by.items() if u != 2)
        assert tfi.fired["prefill"] == 1
    elif name == "chunked_prefill_fault":
        assert (by[3].outcome, by[3].shed_reason) == ("shed", "fault")
    elif name == "queue_depth":
        assert [by[u].outcome for u in range(6)] == ["completed"] * 3 + \
            ["shed"] * 3
        assert rep["shed_queue_depth"] == 3
        assert all(len(by[u].out) == 0 for u in range(3, 6))
    elif name == "pressure_gate":
        assert tsrv.admissions_deferred >= 1


def test_hostile_holder_released_then_completes(baseline):
    """After the squatter releases its blocks the same servers complete the
    whole queue, bitwise the unpressured run, and still agree."""
    pair = run_pair(0, specs_default(), hold=7)
    for (srv, fi, _), R in zip(pair, (jserver.Request, Request)):
        assert fi.release_blocks() == srv.kv_pool.n_blocks - 2 - 7
        srv.kv_pool.check_invariants()
    (jsrv, _, _), (tsrv, _, _) = pair
    jdone = jsrv.serve(requests(specs_default(), jserver.Request))
    tdone = tsrv.serve(requests(specs_default(), Request))
    assert_same(jdone, tdone, jsrv, tsrv)
    assert all(r.outcome == "completed" for r in tdone)
    assert_survivors(tdone, baseline)


@pytest.mark.parametrize("plen", [23, 33])
def test_deadline_pressure_preempts_lower_tier(plen, pressure_refs):
    """A quality request that waits half its deadline parks a resident
    latency-tier victim and completes; the victim resumes bitwise.  With
    chunked prefill (plen 33) the resume admits its parked prompt blocks
    by reference."""
    kw = ({} if plen == 23 else dict(prefill_chunk=8, prefill_interleave=2))
    pool = 0 if plen == 23 else 24
    (jsrv, _, _), (tsrv, _, tdone) = run_pair(
        pool, specs_pressure(plen), tick_s=0.02, **kw)
    assert tsrv.preempt_count >= 1
    victims = [r for r in tdone if r.preemptions > 0]
    assert victims and all(r.sla == "latency" for r in victims)
    assert {r.uid: r.outcome for r in tdone}[2] == "completed"
    assert_survivors(tdone, pressure_refs[plen])
    if plen == 33:
        assert any(r.outcome == "completed" for r in victims)
        assert tsrv.paged_stats()["prefill_chunks_skipped"] >= 1


def test_exhaustion_without_preempt_raises():
    for srv, R, exc in zip(servers(6, preempt=False),
                           (jserver.Request, Request),
                           (jkv.PoolExhausted, tkv.PoolExhausted)):
        with pytest.raises(exc):
            srv.serve(requests(specs_default(), R))


def test_decode_fault_aborts_then_reset_serves_bitwise(baseline):
    """A decode fault aborts both serves; each server resets, and the same
    server object then serves the queue bitwise a fresh server."""
    jsrv, tsrv = servers(0)
    for srv, F, exc in ((jsrv, jfaults, jfaults.InjectedFault),
                        (tsrv, tfaults, tfaults.InjectedFault)):
        fi = F.FaultInjector(seed=0, virtual_clock=True)
        srv.attach_faults(fi)
        fi.arm("decode", after=2, times=1)
        with pytest.raises(exc):
            srv.serve(requests(specs_default(),
                               jserver.Request if F is jfaults else Request))
        assert srv.kv_pool.snapshot()["live_refs"] == 0
        assert (srv.preempt_count, srv.shed_count,
                srv.admissions_deferred) == (0, 0, 0)
        srv.attach_faults(F.FaultInjector(seed=0, virtual_clock=True))
    jdone = jsrv.serve(requests(specs_default(), jserver.Request))
    tdone = tsrv.serve(requests(specs_default(), Request))
    assert_same(jdone, tdone, jsrv, tsrv)
    assert {u: o.tolist() for u, o in outs(tdone).items()} == \
        {u: o.tolist() for u, o in baseline.items()}


def test_reset_restores_paged_and_counter_state():
    jsrv, tsrv = servers(9)
    snaps = []
    for srv, F, R in ((jsrv, jfaults, jserver.Request),
                      (tsrv, tfaults, Request)):
        fi = F.FaultInjector(seed=0, virtual_clock=True)
        srv.attach_faults(fi)
        fi.arm("decode", after=1, times=1)
        with pytest.raises(F.InjectedFault):
            srv.serve(requests(specs_default(), R))
        assert srv.kv_pool.snapshot()["live_refs"] == 0
        assert (srv.preempt_count, srv.shed_count,
                srv.admissions_deferred) == (0, 0, 0)
        srv.kv_pool.check_invariants()
        snaps.append(srv.paged_stats())
    assert snaps[1] == snaps[0]


def test_invalid_overload_config_rejected():
    _, tcfg = _tiny("masked")
    tp = _tiny_params("masked")[1]
    with pytest.raises(ValueError, match="paged"):
        Server(lm, tcfg, ServeConfig(batch=2, max_len=64, preempt=True), tp,
               device="cpu")
    for bad in ({"pressure_gate": 0.0}, {"pressure_gate": 1.5},
                {"max_queue_depth": -1}, {"default_deadline_s": -1.0},
                {"max_preemptions": 0}):
        jsc, tsc = chaos_scfgs(0, **bad)
        with pytest.raises(ValueError):
            jserver.Server(jlm, _tiny("masked")[0], jsc,
                           _tiny_params("masked")[0])
        with pytest.raises(ValueError):
            Server(lm, tcfg, tsc, tp, device="cpu")


def test_overload_fields_match_reference():
    """The overload fields of ServeConfig and Request carry the
    reference's names and defaults."""
    names = ("max_queue_depth", "default_deadline_s", "preempt",
             "pressure_gate", "max_preemptions")
    jd = {f.name: f.default for f in dataclasses.fields(jserver.ServeConfig)}
    td = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    assert {n: td[n] for n in names} == {n: jd[n] for n in names}
    jr = {f.name: f.default for f in dataclasses.fields(jserver.Request)}
    tr = {f.name: f.default for f in dataclasses.fields(Request)}
    assert tr == jr


# ----------------------------------------------------------- the matrix ---

@pytest.mark.parametrize("seed,pool_blocks", [(0, 6), (1, 8), (2, 10),
                                              (3, 0), (4, 6), (5, 0)])
def test_chaos_matrix_matches_reference(seed, pool_blocks, baseline):
    """The reference's randomized chaos cell (``TestChaosMatrix``) on both
    servers: the same draws give both the same chunking, queue depth, gate,
    tick, faults, squatters and deadlines."""
    rng = np.random.default_rng(1000 + seed)
    kw = dict(prefill_chunk=int(rng.choice([0, 8])), prefill_interleave=2,
              max_queue_depth=int(rng.choice([0, 5])),
              pressure_gate=float(rng.choice([1.0, 0.8])))
    tick = float(rng.choice([0.01, 0.05]))
    arms = ()
    if rng.random() < 0.5:
        arms = (dict(point="prefill", times=1,
                     after=int(rng.integers(0, 3))),)
    hold = 0
    if pool_blocks == 0 and rng.random() < 0.5:
        hold = int(rng.integers(2, 8))
    deadlines = None
    if rng.random() < 0.5:
        deadlines = [float(rng.choice([0.0, 2.0])) for _ in PLENS]
    specs = [(u, p, m, s, deadlines[u] if deadlines else d)
             for u, p, m, s, d in specs_default()]
    out = []
    for srv, F, R in zip(servers(pool_blocks, **kw), (jfaults, tfaults),
                         (jserver.Request, Request)):
        fi = F.FaultInjector(seed=seed, virtual_clock=True, tick_s=tick)
        srv.attach_faults(fi)
        for a in arms:
            fi.arm(**a)
        if hold:
            fi.hold_blocks(srv.kv_pool, hold)
        out.append((srv, fi, srv.serve(requests(specs, R))))
    (jsrv, jfi, jdone), (tsrv, tfi, tdone) = out
    assert_same(jdone, tdone, jsrv, tsrv)
    assert tfi.fired == jfi.fired
    assert_terminal(tdone, len(PLENS))
    assert_survivors(tdone, baseline)
    for srv, fi, _ in out:
        fi.release_blocks()
        srv.kv_pool.check_invariants()


# ------------------------------------------------------- the injector ---

def _firings(F, arms, calls, seed=0):
    fi = F.FaultInjector(seed=seed)
    for a in arms:
        fi.arm(**a)
    seq = []
    for point, uid in calls:
        try:
            fi.check(point, uid)
            seq.append(0)
        except F.InjectedFault as e:
            seq.append(str(e))
    return seq, dict(fi.fired)


@pytest.mark.parametrize("arms", [
    (dict(point="prefill", uid=7, after=1, times=2),),
    (dict(point="decode", times=-1, prob=0.3),),
    (dict(point="prefill", times=3, prob=0.5),
     dict(point="decode", after=4, times=2)),
    (dict(point="prefill", uid=None, after=0, times=-1),)])
@pytest.mark.parametrize("seed", [0, 5])
def test_injector_fires_as_reference(arms, seed):
    rng = np.random.default_rng(seed)
    calls = [(str(rng.choice(["prefill", "decode"])),
              int(rng.choice([3, 7])) if rng.random() < 0.8 else None)
             for _ in range(60)]
    assert _firings(tfaults, arms, calls, seed) == \
        _firings(jfaults, arms, calls, seed)


def test_injector_clock_and_holds_match_reference():
    out = []
    for F, KV in ((jfaults, jkv), (tfaults, tkv)):
        fi = F.FaultInjector(virtual_clock=True, tick_s=0.25)
        stamps = [fi.now()]
        for _ in range(3):
            fi.tick()
            stamps.append(fi.now())
        fi.advance(0.5)
        stamps.append(fi.now())
        assert fi.time_source() == fi.now
        p = KV.KVPool(8, 4)
        held = [fi.hold_blocks(p, 99), p.pressure(), fi.release_blocks(2),
                p.pressure(), fi.release_blocks(), p.pressure()]
        p.check_invariants()
        out.append((stamps, held))
    assert out[1] == out[0]
    assert out[1][0][0] == 1.0 and out[1][1][0] == 6
