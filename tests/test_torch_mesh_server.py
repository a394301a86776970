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


@pytest.mark.parametrize("i", range(len(PLACEMENTS)), ids=IDS)
def test_mesh_server_bitwise_one_process(i):
    """Every case on every rank of the placement: everything equal to the
    one-process server's; rank 1's diverging slot arrays make every rank
    raise (2x2 only)."""
    shape, axes = PLACEMENTS[i]
    mismatch = shape == (2, 2)
    outs = run_ranks(MR.serve_cases, shape, axes,
                     args=([c[1:] for c in CASES], 0, mismatch),
                     threads=1, timeout=240)
    m_mesh = dict(zip(axes, shape)).get("model", 1)
    for r, out in enumerate(outs):
        for (label, *_), got, want in zip(CASES, out["cases"], _wants()):
            msg = f"{IDS[i]} rank {r} {label}"
            assert got.pop("rows") == D_FF // m_mesh, msg
            launches = got.pop("launches")
            assert len(launches["per_rank"]) == len(outs), msg
            _same(got, want, msg)
        if mismatch:
            assert "ranks [1] hold other slot arrays" in out["mismatch"], r


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
        for k in ("rows", "launches"):
            got.pop(k)
        _same(got, want1, "first")
    for k in ("shard_density_ema", "shard_union_ema", "active_cap"):
        _same(want2["restored"][k], want1[k], k)
    for o in outs2:
        got = dict(o["cases"][0])
        for k in ("rows", "launches"):
            got.pop(k)
        _same(got, want2, "resumed")
