"""The port's metrics hub against the reference's, on the CPU.

Unit level: ``nearest_rank_pct`` and ``Histogram`` (exact, folded, the
+inf bucket, a cap of 0), counters, gauges, labels and ``complete`` fed the
same observations in both packages must give equal snapshots and
exposition text, byte for byte; ``validate_jsonl`` accepts and rejects the
same lines; the trace is well formed; the first-use watchdog (the port's
stand-in for the reference's retrace watchdog) counts a first use after
``arm()`` and stays silent disarmed or uninstalled.

Serve level: on the virtual clock the port's server emits the JAX server's
events (kinds, uids, tiers, reasons, stamps) and counters under overload;
a controller serve fills the same families and sink files; with the hub
off the tokens and the controller's state are bitwise those with it on.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.configs.base import ControllerConfig as JControllerConfig
from repro.configs.base import MetricsConfig as JMetricsConfig
from repro.configs.base import PagedKVConfig as JPagedKVConfig
from repro.models import lm as jlm
from repro.runtime import faults as jfaults
from repro.runtime import metrics as jm
from repro.runtime import server as jserver
from repro_torch.configs.base import (ControllerConfig, MetricsConfig,
                                      PagedKVConfig)
from repro_torch.models import lm
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import metrics as tm
from repro_torch.runtime.server import Request, Server, ServeConfig
from test_torch_paged_kv import _tiny, _tiny_params


def hubs(**over):
    kw = dict(enabled=True, watchdog=False)
    kw.update(over)
    return (jm.MetricsHub(JMetricsConfig(**kw)),
            tm.MetricsHub(MetricsConfig(**kw)))


def test_metrics_config_matches_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(MetricsConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(JMetricsConfig)]
    assert tm.DEFAULT_BUCKETS == jm.DEFAULT_BUCKETS


# ------------------------------------------------------- percentiles ---

@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 16, 20, 100])
def test_nearest_rank_pct_matches_reference(n):
    vals = list(np.random.default_rng(n).standard_normal(n))
    for q in (0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert tm.nearest_rank_pct(vals, q) == jm.nearest_rank_pct(vals, q)
    assert tm.nearest_rank_pct(list(range(1, 21)), 0.95) == 19


HIST_CASES = {
    "exact": (100, (), [float(v) for v in range(1, 11)]),
    "folded": (4, (1.0, 2.0, 4.0), [0.5, 0.5, 1.5, 3.0, 3.5]),
    "inf_bucket": (1, (1.0,), [5.0, 7.0]),
    "cap_zero": (0, (), [float(v) for v in range(3000)]),
    "stream": (16, tuple(0.05 * 2 ** i for i in range(9)),
               list(np.random.default_rng(3).exponential(1.0, 200))),
    "empty": (8, (), []),
}


@pytest.mark.parametrize("case", list(HIST_CASES))
def test_histogram_matches_reference(case):
    cap, buckets, vals = HIST_CASES[case]
    hj, ht = jm.Histogram(cap, buckets), tm.Histogram(cap, buckets)
    for v in vals:
        hj.observe(v)
        ht.observe(v)
    assert ht.buckets == hj.buckets and ht.counts == hj.counts
    assert ht.exact == hj.exact
    assert ht.snapshot() == hj.snapshot()
    for q in (0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ht.percentile(q) == hj.percentile(q)
    if case == "folded":
        assert not ht.exact and ht.percentile(0.5) == 2.0
    if case == "inf_bucket":
        assert ht.percentile(0.99) == 7.0
    if case == "cap_zero":
        assert ht.exact and ht.percentile(0.5) == 1499.0


def test_bad_buckets_raise_as_reference():
    for bad in ((2.0, 1.0), (1.0, 1.0)):
        for H in (jm.Histogram, tm.Histogram):
            with pytest.raises(ValueError):
                H(buckets=bad)


# ---------------------------------------------------------- the hub ---

def _emit(hub, ticks):
    """One sequence of emits, the same for both hubs."""
    hub.bind_clock(lambda: next(ticks))
    assert hub.inc("requests_shed", reason="deadline") == 1
    assert hub.inc("requests_shed", reason="deadline") == 2
    hub.inc("requests_shed", reason="pool")
    hub.inc("requests_completed", 3)
    hub.set_counter("kv_pool_evicted_blocks", 7)
    hub.set_counter("kv_pool_evicted_blocks", 9)
    hub.set_gauge("alpha", 1.5, layer=0, tier="latency")
    hub.set_gauge("alpha", 1.25, tier="quality", layer=1)
    hub.set_gauge("kv_pool_pressure", 0.625)
    hub.set_gauge("bucket-occupancy.x", 2 ** 60)
    for v in (1.0, 2.0, 3.0, 4.0, 0.123456789):
        hub.observe("latency_s", v, tier="balanced")
    hub.observe("latency_s", 0.5)
    t0 = hub.now()
    hub.complete("decode_step", t0, hist="decode_step_s", step=1)
    with hub.span("prefill", hist="prefill_s", slot=0, uid=np.int64(4)):
        pass
    with hub.span("admission", slot=1):
        pass
    hub.instant("shed", uid=3, reason="pool")
    hub.event("admit", uid=np.int64(1), tier="latency", plen=17,
              queue_wait_s=np.float32(0.25))
    hub.event("complete", uid=1, tokens=8, latency_s=0.25,
              arr=np.arange(3))


def test_hub_snapshot_and_exposition_equal_reference():
    jh, th = hubs(trace=True)
    for hub in (jh, th):
        _emit(hub, iter(float(t) for t in np.arange(1.0, 40.0, 0.25)))
    assert th.snapshot() == jh.snapshot()
    assert th.exposition() == jh.exposition()
    assert th.events() == jh.events()
    jt, tt = jh.trace_events(), th.trace_events()
    assert tt["traceEvents"] == jt["traceEvents"]
    assert tt["displayTimeUnit"] == "ms"
    assert th.counter_value("requests_shed", reason="deadline") == 2
    assert th.gauge_value("alpha", tier="latency", layer=0) == 1.5
    assert th.gauge_value("alpha", layer=1, tier="latency") is None
    assert th.hist_count("latency_s", tier="balanced") == 5
    assert th.hist_mean("decode_step_s", step=1) == 0.25
    lines = th.exposition().splitlines()
    assert "# TYPE sparseinfer_requests_shed counter" in lines
    assert 'sparseinfer_requests_shed{reason="deadline"} 2' in lines
    assert "sparseinfer_retraces_post_warmup 0" in lines


def test_disabled_hub_is_noop():
    hub = tm.MetricsHub(MetricsConfig())
    assert not hub.enabled
    assert hub.inc("c") == 0.0
    hub.set_gauge("g", 1.0)
    hub.set_counter("c", 2)
    hub.observe("h", 1.0)
    hub.event("e")
    hub.instant("i")
    hub.complete("p", 0.0, hist="p_s")
    assert hub.span("s") is tm._NULL_SPAN
    assert hub.events() == []
    assert hub.trace_events()["traceEvents"] == []
    snap = hub.snapshot()
    assert snap["counters"] == snap["gauges"] == snap["histograms"] == {}
    on = tm.MetricsHub(MetricsConfig(enabled=True, watchdog=False))
    assert on.span("s") is tm._NULL_SPAN          # no hist, trace off
    assert on.span("s", hist="s_s") is not tm._NULL_SPAN


def test_hub_config_validation_as_reference():
    for bad in (dict(cadence=0), dict(hist_max_exact=-1),
                dict(events_keep=0)):
        with pytest.raises(ValueError):
            jm.MetricsHub(JMetricsConfig(**bad))
        with pytest.raises(ValueError):
            tm.MetricsHub(MetricsConfig(**bad))


# ------------------------------------------------------------ sinks ---

JSONL_CASES = ["not json\n", "[1, 2]\n", '{"kind": "x"}\n',
               '{"ts": true, "kind": "x"}\n', '{"ts": 1.0, "kind": ""}\n',
               '{"ts": 1.0}\n', "", "\n\n",
               '{"ts": 1, "kind": "a"}\n\n{"ts": 2.5, "kind": "b", "x": 1}\n',
               '{"ts": 1.0, "kind": "a"}\nnot json\n']


@pytest.mark.parametrize("i", range(len(JSONL_CASES)))
def test_validate_jsonl_as_reference(tmp_path, i):
    p = str(tmp_path / "m.jsonl")
    with open(p, "w") as f:
        f.write(JSONL_CASES[i])
    got = []
    for fn in (jm.validate_jsonl, tm.validate_jsonl):
        try:
            got.append(("ok", fn(p)))
        except ValueError as e:
            got.append(("error", str(e)))
    assert got[1] == got[0]


def test_sinks_written_and_well_formed(tmp_path):
    jl, tr, sn = (str(tmp_path / n) for n in ("m.jsonl", "t.json", "s.prom"))
    hub = tm.MetricsHub(MetricsConfig(enabled=True, watchdog=False,
                                      jsonl_path=jl, trace_path=tr,
                                      snapshot_path=sn))
    _emit(hub, iter(float(t) for t in np.arange(1.0, 40.0, 0.25)))
    hub.close()
    assert tm.validate_jsonl(jl) == 2
    recs = [json.loads(line) for line in open(jl)]
    assert recs[0]["kind"] == "admit" and recs[0]["uid"] == 1
    assert recs[1]["arr"] == [0, 1, 2]
    doc = json.load(open(tr))
    evs = doc["traceEvents"]
    assert len(evs) == 4 and len({e["tid"] for e in evs}) == 4
    for ev in evs:
        assert ev["ph"] in ("X", "i") and ev["ts"] >= 0.0
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        if ev["ph"] == "X":
            assert ev["dur"] >= 0.0
    assert evs[1]["args"] == {"slot": 0, "uid": 4}
    assert open(sn).read() == hub.exposition()


# --------------------------------------------------------- watchdog ---

def test_watchdog_counts_first_use_after_arm():
    hub = tm.MetricsHub(MetricsConfig(enabled=True, watchdog=True))
    quiet = tm.MetricsHub(MetricsConfig(enabled=True, watchdog=False))
    try:
        rep = hub.watchdog.report()
        assert rep == {"installed": True, "armed": False, "compiles": 0,
                       "retraces_post_warmup": 0}
        assert set(rep) == set(jm.RetraceWatchdog().report())
        tm.note_first_use("capacity bucket 16")        # before arm: counted
        assert hub.watchdog.compiles == 1
        assert hub.watchdog.retraces_post_warmup == 0
        hub.watchdog.arm()
        with pytest.warns(UserWarning, match="post-warmup retrace"):
            tm._on_library_load("fused_sparse_mlp")    # a library load
        assert hub.watchdog.retraces_post_warmup == 1
        assert hub.counter_value("retrace_post_warmup") == 1
        assert [e["kind"] for e in hub.events()] == ["retrace"]
        assert "retraces_post_warmup 1" in hub.exposition()
        assert not quiet.watchdog.report()["installed"]
        hub.watchdog.disarm()
        tm.note_first_use("capacity bucket 32")        # disarmed: silent
        assert hub.watchdog.retraces_post_warmup == 1
        assert hub.watchdog.compiles == 3
    finally:
        hub.close()
    n = hub.watchdog.compiles
    tm.note_first_use("capacity bucket 64")            # uninstalled
    assert hub.watchdog.compiles == n
    assert not hub.watchdog.report()["installed"]


def _ladder_server(**over):
    cfg = _tiny("pallas")[1]
    cfg = cfg.replace(d_ff=512, sparse=dataclasses.replace(
        cfg.sparse, capacity_buckets=(0.25, 0.5, 1.0)))
    kw = dict(batch=2, max_len=48, metrics=MetricsConfig(enabled=True),
              controller=ControllerConfig(enabled=True, per_tier=True))
    kw.update(over)
    return Server(lm, cfg, ServeConfig(**kw), lm.init_lm(cfg, 0, "cpu"),
                  device="cpu")


def _mk_requests(n=4, max_new=6):
    return [Request(uid=i, prompt=np.arange(1 + i, 6 + i), max_new=max_new,
                    sla="latency" if i % 2 else "balanced")
            for i in range(n)]


def test_warmed_bucket_ladder_stays_silent():
    srv = _ladder_server(warm_buckets=True)
    try:
        srv.serve(_mk_requests())            # drain 1: warm and arm
        assert srv.metrics.watchdog.armed
        assert len(srv._trace_counts) == 3
        srv.serve(_mk_requests(n=6))         # drain 2: nothing new
        assert srv.metrics.watchdog.retraces_post_warmup == 0
        assert srv.metrics.counter_value("retrace_post_warmup") == 0
    finally:
        srv.metrics.close()


def test_unwarmed_bucket_first_use_after_arm_counts():
    """Without the warmup a bucket first used after the first drain is the
    post-warmup first use the watchdog exists for."""
    srv = _ladder_server()
    try:
        srv.serve(_mk_requests())
        used = set(srv._trace_counts)
        unused = sorted(set(srv._bucket_cfgs) - used)
        assert unused, srv._trace_counts
        g = srv.cfg.sparse.group_size
        srv.controller.capacity_hint = lambda k: unused[0] * g
        with pytest.warns(UserWarning, match="post-warmup retrace"):
            srv.serve(_mk_requests())
        assert srv.metrics.watchdog.retraces_post_warmup >= 1
        assert any(e["kind"] == "retrace" for e in srv.metrics.events())
        assert srv.metrics.counter_value("bucket_switches") >= 1
    finally:
        srv.metrics.close()


# -------------------------------------------------------- the server ---

def _overload_pair(mk_metrics, **kw):
    """The JAX and port servers on the tiny masked paged config under a 2x
    oversubscribed pool, a deadline, a prefill fault and chunked prefill,
    each on its own virtual clock."""
    jcfg, tcfg = _tiny("masked")
    jp, tp = _tiny_params("masked")
    base = dict(batch=2, max_len=64, preempt=True, default_deadline_s=100.0,
                prefill_chunk=8, prefill_interleave=2, **kw)
    rng = np.random.default_rng(0)
    specs = [(i, rng.integers(0, 128, size=p), 6, s, 0.06 if i == 4 else 0.0)
             for i, (p, s) in enumerate(zip(
                 (17, 21, 19, 23, 15, 22),
                 ("latency", "quality", "balanced", "quality", "balanced",
                  "latency")))]
    out = []
    for S, C, PK, MC, F, R, mod, p, cfg in (
            (jserver.Server, jserver.ServeConfig, JPagedKVConfig,
             JMetricsConfig, jfaults, jserver.Request, jlm, jp, jcfg),
            (Server, ServeConfig, PagedKVConfig, MetricsConfig, tfaults,
             Request, lm, tp, tcfg)):
        scfg = C(paged_kv=PK(block_size=8, pool_blocks=8),
                 metrics=mk_metrics(MC), **base)
        srv = (S(mod, cfg, scfg, p) if S is jserver.Server
               else S(mod, cfg, scfg, p, device="cpu"))
        fi = F.FaultInjector(seed=0, virtual_clock=True, tick_s=0.01)
        srv.attach_faults(fi)
        fi.arm("prefill", uid=2, after=1, times=1)
        done = srv.serve([R(uid=u, prompt=pp, max_new=m, sla=s,
                            deadline_s=d) for u, pp, m, s, d in specs])
        out.append((srv, done))
    return out


def test_overload_serve_emits_reference_events():
    (jsrv, jdone), (tsrv, tdone) = _overload_pair(
        lambda M: M(enabled=True, trace=True, watchdog=False, cadence=2))
    try:
        jev, tev = jsrv.metrics.events(), tsrv.metrics.events()
        kinds = {e["kind"] for e in tev}
        assert {"serve_start", "admit", "first_token", "complete", "shed",
                "preempt", "serve_end"} <= kinds
        assert {e["reason"] for e in tev if e["kind"] == "shed"} >= \
            {"fault", "deadline"}
        assert tev == jev
        js, ts = jsrv.metrics.snapshot(), tsrv.metrics.snapshot()
        assert ts["counters"] == js["counters"]
        assert ts["histograms"] == js["histograms"]
        assert set(ts["gauges"]) == set(js["gauges"])
        for k in ts["gauges"]:
            assert ts["gauges"][k] == js["gauges"][k], k
        assert ts["retraces_post_warmup"] == 0
        jt = [(e["name"], e["ph"], e["ts"], e.get("dur"), e["args"])
              for e in jsrv.metrics.trace_events()["traceEvents"]]
        tt = [(e["name"], e["ph"], e["ts"], e.get("dur"), e["args"])
              for e in tsrv.metrics.trace_events()["traceEvents"]]
        assert tt == jt
        assert tsrv.metrics.exposition() == jsrv.metrics.exposition()
        assert tsrv.metrics_report()["events"] == len(jev)
    finally:
        jsrv.metrics.close()
        tsrv.metrics.close()


def test_metrics_off_is_bitwise_metrics_on():
    (_, _), (ton, don) = _overload_pair(
        lambda M: M(enabled=True, trace=True, watchdog=False))
    (_, _), (toff, doff) = _overload_pair(lambda M: M())
    try:
        rec = [{r.uid: (r.outcome, r.shed_reason, r.preemptions,
                        np.asarray(r.out).tolist(), r.t_end) for r in d}
               for d in (don, doff)]
        assert rec[0] == rec[1]
        assert toff.paged_stats() == ton.paged_stats()
        assert toff.metrics.span("x") is tm._NULL_SPAN
        assert toff.metrics_report() == {
            "enabled": False, "watchdog": toff.metrics.watchdog.report()}
    finally:
        ton.metrics.close()


def _controller_pair(tmp_path, tag):
    out = []
    for pkg in ("j", "t"):
        jcfg, tcfg = _tiny("pallas")
        jp, tp = _tiny_params("pallas")
        files = {k: str(tmp_path / f"{pkg}{tag}.{k}")
                 for k in ("jsonl", "trace", "prom")}
        kw = dict(enabled=True, jsonl_path=files["jsonl"], trace=True,
                  trace_path=files["trace"], snapshot_path=files["prom"],
                  cadence=2, watchdog=pkg == "t")
        if pkg == "j":
            scfg = jserver.ServeConfig(
                batch=2, max_len=48, metrics=JMetricsConfig(**kw),
                controller=JControllerConfig(enabled=True, per_tier=True),
                paged_kv=JPagedKVConfig(block_size=8))
            srv = jserver.Server(jlm, jcfg, scfg, jp)
            R = jserver.Request
        else:
            scfg = ServeConfig(
                batch=2, max_len=48, metrics=MetricsConfig(**kw),
                controller=ControllerConfig(enabled=True, per_tier=True),
                paged_kv=PagedKVConfig(block_size=8))
            srv = Server(lm, tcfg, scfg, tp, device="cpu")
            R = Request
        srv.serve([R(uid=i, prompt=np.arange(1 + i, 6 + i), max_new=6,
                     sla="latency" if i % 2 else "balanced")
                   for i in range(4)])
        out.append((srv, files))
    return out


def test_controller_serve_fills_every_family(tmp_path):
    """The families and sink files of the reference's
    ``test_serve_emits_every_family``, and the same instrument keys as the
    JAX server's on the same serve."""
    (jsrv, _), (srv, files) = _controller_pair(tmp_path, "c")
    try:
        hub = srv.metrics
        snap = hub.snapshot()
        g = snap["gauges"]
        for key in ('tier_realized_density{tier="latency"}',
                    'tier_realized_density{tier="balanced"}',
                    'alpha{layer="0",tier="latency"}',
                    'layer_density{layer="1",tier="balanced"}',
                    "kv_pool_pressure"):
            assert key in g, key
        assert g["kv_pool_n_blocks"] > 0
        assert hub.percentile("latency_s", 0.95, tier="balanced") > 0.0
        assert hub.hist_count("decode_step_s") > 0
        assert snap["counters"]["requests_completed"] == 4
        assert snap["retraces_post_warmup"] == 0
        assert tm.validate_jsonl(files["jsonl"]) > 0
        assert {"serve_start", "admit", "first_token", "complete",
                "serve_end"} <= {e["kind"] for e in hub.events()}
        names = {e["name"] for e in json.load(open(files["trace"]))[
            "traceEvents"]}
        assert {"prefill", "decode_step", "controller_update",
                "admission"} <= names
        expo = open(files["prom"]).read()
        assert "sparseinfer_tier_realized_density" in expo
        assert ('sparseinfer_latency_s{tier="balanced",quantile="0.95"}'
                in expo)
        js = jsrv.metrics.snapshot()
        for part in ("counters", "gauges", "histograms"):
            assert set(snap[part]) == set(js[part]), part
        fam = [ln for ln in expo.splitlines() if ln.startswith("# TYPE")]
        jfam = [ln for ln in jsrv.metrics.exposition().splitlines()
                if ln.startswith("# TYPE")]
        assert fam == jfam
        rep = srv.metrics_report()
        assert rep["enabled"] and rep["watchdog"]["armed"]
        assert rep["events"] == len(hub.events())
    finally:
        jsrv.metrics.close()
        srv.metrics.close()


# ----------------------------------------------------------- the CLI ---

def test_serve_cli_overload_and_metrics(tmp_path, monkeypatch, capsys):
    """The serve CLI at reduced dims on the CPU with the overload and
    metrics flags: the report carries the reference's overload keys and
    its ``metrics`` block, the JSONL validates, and ``--alpha`` sets
    ``alpha_base`` and ``alpha_early`` as the reference's CLI does."""
    from repro_torch.launch import serve as serve_cli
    seen = {}

    class Recording(serve_cli.Server):
        def __init__(self, mod, cfg, scfg, params, device):
            seen["cfg"], seen["scfg"] = cfg, scfg
            super().__init__(mod, cfg, scfg, params, device=device)

    monkeypatch.setattr(serve_cli, "Server", Recording)
    jl = str(tmp_path / "m.jsonl")
    rep = serve_cli.main([
        "--arch", "prosparse-llama2-7b", "--reduced", "--device", "cpu",
        "--strategy", "masked", "--requests", "6", "--batch", "2",
        "--max-new", "4", "--prompt-len", "12", "--max-len", "64",
        "--paged-kv", "8", "--pool-blocks", "6", "--preempt",
        "--default-deadline", "600", "--max-queue-depth", "5",
        "--pressure-gate", "0.95", "--metrics", "--metrics-jsonl", jl,
        "--alpha", "1.03", "--sla-mix", "latency:1,balanced:1,quality:1"])
    assert '"metrics"' in capsys.readouterr().out
    sp = seen["cfg"].sparse
    assert (sp.alpha_base, sp.alpha_early) == (1.03, 1.03)
    assert rep["sparse"]["alpha"] == 1.03
    scfg = seen["scfg"]
    assert (scfg.preempt, scfg.default_deadline_s, scfg.max_queue_depth,
            scfg.pressure_gate, scfg.metrics.enabled,
            scfg.metrics.jsonl_path) == (True, 600.0, 5, 0.95, True, jl)
    for k in ("shed", "shed_rate", "preempted", "preemptions", "completed"):
        assert k in rep, k
    assert rep["shed_queue_depth"] == 1 and rep["requests"] == 6
    assert rep["completed"] + rep["shed"] == 6
    assert {"preemptions", "shed", "admissions_deferred"} <= set(rep["paged"])
    m = rep["metrics"]
    assert set(m) == {"enabled", "watchdog", "snapshot", "events",
                      "trace_events", "sinks"}
    assert m["sinks"] == {"jsonl": jl} and m["watchdog"]["armed"]
    assert m["snapshot"]["counters"]['requests_shed{reason="queue_depth"}'] \
        == 1
    assert tm.validate_jsonl(jl) == m["events"]


@pytest.mark.parametrize("enabled", [False, True])
def test_server_freed_without_the_cycle_collector(enabled):
    """A dropped server frees at once, hub on or off: its hub holds no
    reference back to it (a cycle would keep the weights on the card until
    the cycle collector ran, and the next server's would not fit)."""
    import gc
    import weakref
    _, tcfg = _tiny("masked")
    gc.disable()
    try:
        srv = Server(lm, tcfg, ServeConfig(
            batch=2, max_len=64, paged_kv=PagedKVConfig(block_size=8),
            metrics=MetricsConfig(enabled=enabled, trace=enabled)),
            _tiny_params("masked")[1], device="cpu")
        srv.attach_faults(tfaults.FaultInjector(virtual_clock=True))
        srv.serve([Request(uid=0, prompt=np.arange(10), max_new=3)])
        srv.metrics.close()
        ref = weakref.ref(srv)
        del srv
        assert ref() is None
    finally:
        gc.enable()
