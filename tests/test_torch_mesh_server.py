"""``Server(mesh=...)`` on gloo ranks of the CPU against the one-process
server of the port with the same (dp_shards, tp_shards) grid: the
counterparts of the reference's mesh-server tests
(``tests/test_distributed.py`` TestMeshServer, TestMesh2DServer,
TestMesh2DServerInt8 and the 2-D restart).

Reduced prosparse-llama2-7b with d_ff=512 (``tests/test_torch_
distributed.py``'s), grid (2, 2), batch 4, 6 requests of mixed SLA tiers.
Each placement (2x2, 1x2 over ('model',), 2x1) is one spawn that serves
every case: pallas with the per-tier controller over the 9-tuple per-shard
bucket ladder (warmed), gather with masked audits on a paged pool with
chunked prefill, masked with chunked prefill on the dense cache, int8
weights (qg 32) under pallas, and the legacy chunked scheduler (gather, no
controller).  Every rank's tokens, outcomes, decode steps, pool counters,
bucket sequence, controller report and every EMA (``alphas``,
``density_ema``, ``fn_ema``, ``union_ema``, ``predicted_ema``,
``shard_density_ema``, ``shard_union_ema``) equal the one-process
server's, and each rank kept d_ff/m_mesh rows.  Then a checkpoint written
on one placement (rank 0 only) resumes on another.  The rejections and the
launcher are ``tests/test_torch_mesh_launch.py``'s.

The 'data' axis splits the slots (2x2 and 2x1: two lines of two slots
each): every rank reports its line's slot range and KV bytes, and every
decode step ran on the line's 2 rows against caches of 2 slots (a paged
pool stays whole).  The same spawns run teacher-forced decode on 2x1
(``tests/test_torch_mesh_place.py``'s cases against one process), a
two-turn session whose turn 2 lands on the other line (tokens, chain and
pool blocks against one process), and two mutations that must fail: the
slot range shifted by one slot, and the session's blocks not broadcast.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro_torch.configs.base import ControllerConfig, PagedKVConfig
from repro_torch.configs.registry import reduced_config
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import lm as tlm
from repro_torch.runtime.server import Server, ServeConfig

import _torch_mesh_ranks as MR
from test_torch_mesh_place import TOL, check_forced, forced_args

ARCH = "prosparse-llama2-7b"
B, D_FF = 4, 512
CCFG = dict(enabled=True, target_density=0.2, gain=1.0, ema=0.5,
            audit_period=4, fn_budget=0.5, per_tier=True)
PLACEMENTS = (((2, 2), ("data", "model")), ((2,), ("model",)),
              ((2, 1), ("data", "model")))
IDS = ["2x2", "model2", "2x1"]


def _cfg(strategy: str, buckets=(), weights="", ds=2, ms=2, **kw):
    cfg = reduced_config(ARCH)
    return cfg.replace(d_ff=D_FF, sparse=dataclasses.replace(
        cfg.sparse, strategy=strategy, capacity_frac=0.5,
        capacity_buckets=buckets, sparse_prefill=True, tp_shards=ms,
        dp_shards=ds, weight_dtype=weights, quant_group_size=32, **kw))


def _spec(seed: int, n: int = 6,
          slas=("latency", "balanced", "quality")) -> list:
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, size=int(rng.integers(5, 21))),
             int(rng.integers(5, 10)), slas[i % len(slas)])
            for i in range(n)]


def _scfg(**kw) -> ServeConfig:
    ctl = kw.pop("controller", True)
    return ServeConfig(batch=B, max_len=64, controller=ControllerConfig(
        **CCFG) if ctl else ControllerConfig(), **kw)


CASES = (
    ("pallas ladder", _cfg("pallas", (0.25, 0.5, 1.0)),
     _scfg(warm_buckets=True), _spec(3)),
    ("gather paged", _cfg("gather"),
     _scfg(prefill_chunk=8, prefill_interleave=2,
           paged_kv=PagedKVConfig(block_size=8)), _spec(4)),
    ("masked chunked", _cfg("masked"), _scfg(prefill_chunk=8), _spec(5)),
    ("pallas int8", _cfg("pallas", weights="int8"), _scfg(), _spec(6)),
    ("gather legacy", _cfg("gather"),
     _scfg(controller=False, slot_refill=False),
     _spec(7, 5, ("balanced",))),
)


def _one_process(cfg, scfg, spec, save_step: int = 0) -> dict:
    srv = Server(tlm, cfg, scfg, tlm.init_lm(cfg, 0, "cpu"), device="cpu")
    restored = MR._state(srv, [])
    st = MR._state(srv, srv.serve(MR._requests(spec)))
    st["restored"] = restored
    if save_step:
        st["saved"] = srv.save_controller(save_step)
    return st


@functools.lru_cache(maxsize=None)
def _wants() -> list:
    return [_one_process(cfg, scfg, spec) for _, cfg, scfg, spec in CASES]


def _same(got, want, path=""):
    """Equal leaf for leaf: arrays with ``array_equal``, the rest with
    ``==`` (floats too: the mesh must be bitwise)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)) and not (
            want and isinstance(want[0], (int, float))):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


# what the placements with a 'data' axis run besides CASES: teacher-forced
# decode (2x1; place_2d runs 2x2's), the session across lines and the
# mutations
FORCED_2X1 = ("7b pallas dense f32", "7b gather chunk int8-kv",
              "7b masked paged-kernel")
SESSION_CFG = (_cfg("gather"), _scfg(controller=False, prefill_chunk=8,
                                     paged_kv=PagedKVConfig(block_size=8)))
# turn 1: the session's request in slot 2 (line 1), 10 prompt tokens and
# 8 new (17 tokens' KV: block 1 holds decode-written KV); turn 2 (slot 0,
# line 0) adopts blocks 0 and 1 and prefills 6 more tokens
SESSION_TURN1 = [(0, _spec(11, 1)[0][1], 3, "balanced"),
                 (1, _spec(12, 1)[0][1], 4, "balanced"),
                 (2, np.random.default_rng(13).integers(0, 512, 10), 8,
                  "balanced")]
SESSION_TAIL, SESSION_NEW = np.random.default_rng(14).integers(0, 512, 6), 6
SHIFTED = (_cfg("gather"), _scfg(controller=False), _spec(15, 4))


def _lines(i: int) -> int:
    shape, axes = PLACEMENTS[i]
    return dict(zip(axes, shape)).get("data", 1)


@functools.lru_cache(maxsize=None)
def _ranked(i: int) -> list:
    """Every rank's ``MR.serve_cases`` of placement ``i``, one spawn: the
    CASES, and on a 'data' axis the session, the mutations and (2x1) the
    teacher-forced cases."""
    shape, axes = PLACEMENTS[i]
    extras = (0, shape == (2, 2))
    if _lines(i) > 1:
        extras += (forced_args(shape, FORCED_2X1) if shape == (2, 1)
                   else (), SESSION_CFG + (SESSION_TURN1, SESSION_TAIL,
                                           SESSION_NEW), SHIFTED)
    return run_ranks(MR.serve_cases, shape, axes,
                     args=([c[1:] for c in CASES],) + extras,
                     threads=1, timeout=240)


@pytest.mark.parametrize("i", range(len(PLACEMENTS)), ids=IDS)
def test_mesh_server_bitwise_one_process(i):
    """Every case on every rank of the placement: everything equal to the
    one-process server's; rank 1's diverging slot arrays make every rank
    raise (2x2 only)."""
    shape, axes = PLACEMENTS[i]
    mismatch = shape == (2, 2)
    outs = _ranked(i)
    m_mesh = dict(zip(axes, shape)).get("model", 1)
    for r, out in enumerate(outs):
        for (label, *_), got, want in zip(CASES, out["cases"], _wants()):
            msg = f"{IDS[i]} rank {r} {label}"
            got = dict(got)
            assert got.pop("rows") == D_FF // m_mesh, msg
            launches = got.pop("launches")
            assert len(launches["per_rank"]) == len(outs), msg
            for k in ("slots", "shapes"):
                got.pop(k)
            _same(got, want, msg)
        if mismatch:
            assert "ranks [1] hold other slot arrays" in out["mismatch"], r


@pytest.mark.parametrize("i", range(len(PLACEMENTS)), ids=IDS)
def test_slot_ranges_caches_and_kv_bytes(i):
    """Each rank's line owns the contiguous slots [j*B/D, (j+1)*B/D);
    every decode step ran on B/D token rows against dense caches of B/D
    slots at the rank's KV heads (a paged pool: every block, the rank's
    heads); the reported KV bytes are the one-device KV's share: 1/D of
    the slots (dense) times the rank's heads."""
    shape, axes = PLACEMENTS[i]
    d, m = _lines(i), dict(zip(axes, shape)).get("model", 1)
    cfg0 = CASES[0][1]
    hd, kvh = cfg0.resolved_head_dim, cfg0.n_kv_heads
    for r, out in enumerate(_ranked(i)):
        line = r // m if "data" in axes else 0
        want_slots = [line * B // d, (line + 1) * B // d]
        for (label, cfg, scfg, _), got in zip(CASES, out["cases"]):
            msg = f"{IDS[i]} rank {r} {label}"
            slots = got["slots"]
            assert [p["slots"] for p in slots["per_rank"]] == [
                [q * B // d, (q + 1) * B // d]
                for q in ((k // m if "data" in axes else 0)
                          for k in range(len(slots["per_rank"])))], msg
            assert slots["per_rank"][r]["slots"] == want_slots, msg
            paged = scfg.paged_kv is not None
            share = (kvh // m) / kvh / (1 if paged else d)
            assert slots["per_rank"][r]["kv_bytes"] == \
                slots["one_device_kv_bytes"] * share, msg
            for rows, kshape in got["shapes"]:
                assert rows == B // d, msg
                want = ((None, 8) if paged
                        else (B // d, scfg.max_len)) + (kvh // m, hd)
                assert kshape[1:] == want[1:], msg
                assert paged or kshape[0] == B // d, msg


def _session_want() -> dict:
    cfg, scfg = SESSION_CFG
    return MR.session_turns(MR._server(None, cfg, scfg), SESSION_TURN1,
                            SESSION_TAIL, SESSION_NEW)


@pytest.mark.parametrize("i", [0, 2], ids=[IDS[0], IDS[2]])
def test_session_across_lines_matches_one_process(i):
    """A session kept by slot 2 (line 1) continued in slot 0 (line 0):
    every rank's tokens of both turns and the session's final chain equal
    one process's, its blocks of every pool leaf within ``TOL`` of the
    one process's at the rank's KV heads, after the owner lines
    broadcast the decode-written blocks of both turns (2 blocks each)."""
    shape, axes = PLACEMENTS[i]
    m = dict(zip(axes, shape))["model"]
    want = _session_want()
    assert want["reused"] == 2
    cfg = SESSION_CFG[0]
    kv_l = cfg.n_kv_heads // m
    for r, out in enumerate(_ranked(i)):
        got, msg = out["session"], f"{IDS[i]} rank {r}"
        _same(got["tokens"], want["tokens"], msg)
        assert got["chain"] == want["chain"] and got["reused"] == 2, msg
        k0 = (r % m) * kv_l
        block = 0
        for lg, lw in zip(got["blocks"], want["blocks"]):
            for name, v in lw.items():
                np.testing.assert_allclose(
                    lg[name], v[:, :, k0:k0 + kv_l], **TOL,
                    err_msg=f"{msg} {name}")
                block += lg[name][0].nbytes
        assert got["shared_bytes"] == 4 * block, msg


@pytest.mark.parametrize("i", [0, 2], ids=[IDS[0], IDS[2]])
def test_mutations_fail(i):
    """Two deliberately broken runs on the same ranks: the lines reading
    the slots one past their own (tokens land in the wrong slots), and
    the session's decode-written blocks not broadcast (turn 2's line
    prefills over stale blocks: its first token diverges between the
    lines, or its tokens or chain blocks leave one process's)."""
    cfg, scfg, spec = SHIFTED
    srv = MR._server(None, cfg, scfg)
    want = MR._state(srv, srv.serve(MR._requests(spec)))["tokens"]
    sess = _session_want()
    for r, out in enumerate(_ranked(i)):
        msg = f"{IDS[i]} rank {r}"
        shifted = out["shifted"]
        assert "raised" in shifted or any(
            not np.array_equal(shifted["tokens"][u], want[u])
            for u in want), msg
        un = out["session_unshared"]
        if "raised" in un:
            assert "hold other slot arrays" in un["raised"], msg
            continue
        m = dict(zip(PLACEMENTS[i][1], PLACEMENTS[i][0]))["model"]
        kv_l = cfg.n_kv_heads // m
        k0 = (r % m) * kv_l
        close = all(np.allclose(lg[n], lw[n][:, :, k0:k0 + kv_l], **TOL)
                    for lg, lw in zip(un["blocks"], sess["blocks"])
                    for n in lw)
        same = all(np.array_equal(un["tokens"][u], sess["tokens"][u])
                   for u in sess["tokens"])
        # the stale blocks sit in line 0's pools; line 1's are current
        assert not (close and same) or r // m == 1, msg
        if r // m == 0:
            assert not close, msg


def test_forced_decode_2x1_matches_one_process():
    """Teacher-forced decode on 2x1: each line's slots through the model,
    gathered over 'data' (dense, chunked prefill with int8 KV, the paged
    kernels' route): logits within ``TOL`` of one process fed the ranks'
    MLP inputs, every rank bitwise rank 0, tokens and stats equal."""
    check_forced((2, 1), [o["forced"] for o in _ranked(2)], FORCED_2X1)


def test_controller_checkpoint_resumes_on_another_placement(tmp_path):
    """A gather serve with a 2-rung ladder on 1x2 (model) writes its
    controller checkpoint from rank 0 alone; a server on 2x1 (data)
    restores it (the shard EMAs and the bucket they steer) and serves on,
    all equal to one process doing the same."""
    cfg = _cfg("gather", (0.25, 1.0))
    first, then = _spec(8, 4), _spec(9, 2)

    def scfg(d):
        return _scfg(controller_ckpt=str(tmp_path / d))
    want1 = _one_process(cfg, scfg("one"), first, save_step=1000)
    want2 = _one_process(cfg, scfg("one"), then)
    assert want1["saved"] == 1000
    outs1 = run_ranks(MR.serve_cases, (2,), ("model",),
                      args=([(cfg, scfg("mesh"), first)], 1000),
                      threads=1, timeout=240)
    assert [o["cases"][0]["saved"] for o in outs1] == [1000, None]
    outs2 = run_ranks(MR.serve_cases, (2, 1), ("data", "model"),
                      args=([(cfg, scfg("mesh"), then)],),
                      threads=1, timeout=240)
    saved = want1.pop("saved")
    for o in outs1:
        got = dict(o["cases"][0])
        assert got.pop("saved") in (saved, None)
        for k in ("rows", "launches", "slots", "shapes"):
            got.pop(k)
        _same(got, want1, "first")
    for k in ("shard_density_ema", "shard_union_ema", "active_cap"):
        _same(want2["restored"][k], want1[k], k)
    for o in outs2:
        got = dict(o["cases"][0])
        for k in ("rows", "launches", "slots", "shapes"):
            got.pop(k)
        _same(got, want2, "resumed")
