"""The port's slot-refill server on the CPU: scheduling properties and the
dead-slot union rule.  Free-running greedy tokens are not compared with the
JAX server: on near-flat random logits a 1e-6 drift flips them."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import reduced_config
from repro_torch.core import predictor as P
from repro_torch.core import selection as S
from repro_torch.core import sparse_mlp as SM
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                        throughput_report)

ARCH = "prosparse-llama2-7b"


def _cfg(strategy: str):
    cfg = reduced_config(ARCH)
    return cfg.replace(sparse=dataclasses.replace(
        cfg.sparse, strategy=strategy, enabled=strategy != "dense"))


def _requests(rng, n, plens, max_news, vocab, slas=("balanced",)):
    return [Request(uid=i, prompt=rng.integers(0, vocab, size=int(plens[i])),
                    max_new=int(max_news[i]), sla=slas[i % len(slas)])
            for i in range(n)]


def test_slot_refill_matches_single_request_generate():
    """Every request of a randomly ordered queue of mixed lengths gets
    exactly the tokens a single-request generate() of the same model gives
    (dense strategy, batch 2)."""
    cfg = _cfg("dense")
    params = lm.init_lm(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    reqs = _requests(rng, 6, rng.choice([4, 6, 8], size=6),
                     rng.integers(1, 7, size=6), cfg.vocab)
    rng.shuffle(reqs)
    srv = Server(lm, cfg, ServeConfig(batch=2, max_len=32), params,
                 device="cpu")
    done = srv.serve(reqs)
    assert sorted(r.uid for r in done) == list(range(6))
    single = Server(lm, cfg, ServeConfig(batch=1, max_len=32), params,
                    device="cpu")
    for r in done:
        assert r.out.shape == (r.max_new,) and r.outcome == "completed"
        assert r.latency_s > 0 and r.t_end >= r.t_start
        want = single.generate(np.asarray(r.prompt)[None, :], r.max_new)[0]
        np.testing.assert_array_equal(r.out, want, err_msg=f"uid {r.uid}")


def test_pallas_mixed_sla_completes():
    cfg = _cfg("pallas")
    srv = Server(lm, cfg, ServeConfig(batch=2, max_len=32),
                 lm.init_lm(cfg, 1, device="cpu"), device="cpu")
    rng = np.random.default_rng(1)
    reqs = _requests(rng, 5, rng.integers(3, 9, size=5), [4] * 5, cfg.vocab,
                     slas=("latency", "balanced", "quality"))
    done = srv.serve(reqs)
    assert len(done) == 5
    for r in done:
        assert r.outcome == "completed" and r.out.shape == (4,)
        assert ((r.out >= 0) & (r.out < cfg.vocab)).all()
    rep = throughput_report(done)
    assert rep["completed"] == 5 and rep["tokens"] == 20
    assert rep["shed"] == 0 and rep["tok_per_s"] > 0
    # 3 decode steps per request at most, spread over 2 slots
    assert 0 < srv.decode_steps <= 15


def test_dead_slot_alpha_leaves_union():
    """A DEAD_SLOT_ALPHA slot predicts all-sparse, so the live slot gets the
    selection (and output) it gets alone; without the dead alpha the second
    row changes the selection."""
    d, k = 64, 128
    gen = torch.Generator().manual_seed(0)
    params = SM.prepare_sparse_params(SM.init_gated_mlp(gen, d, k))
    x = torch.randn((2, d), generator=gen)
    cfg = SM.SparseInferConfig(enabled=True, strategy="pallas",
                               activation="relu", group_size=8,
                               capacity_frac=0.1)
    cap = cfg.capacity(k)

    def selection(xx, alpha):
        gm, _ = ops.predict_group_margins(params["sign_wg"], xx, d, alpha)
        return S.capacity_select(S.union_margin(gm), cap)

    alone = selection(x[:1], 1.0)
    mixed = selection(x, torch.tensor([1.0, SM.DEAD_SLOT_ALPHA]))
    polluted = selection(x, 1.0)
    assert torch.equal(alone.indices, mixed.indices)
    assert int(alone.count) == int(mixed.count)
    assert not torch.equal(alone.indices, polluted.indices)
    y1 = SM.pallas_mlp(params, x[:1], cfg, alpha=1.0)
    y2 = SM.pallas_mlp(params, x, cfg,
                       alpha=torch.tensor([1.0, SM.DEAD_SLOT_ALPHA]))
    # same groups, same products: a batch of 2 may only change the CPU
    # matmul's summation order
    torch.testing.assert_close(y2[:1], y1, rtol=1e-6, atol=1e-6)


def test_serve_validates_queue_and_config():
    cfg = _cfg("dense")
    params = lm.init_lm(cfg, 2, device="cpu")
    srv = Server(lm, cfg, ServeConfig(batch=2, max_len=16), params,
                 device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        srv.serve([Request(uid=0, prompt=np.zeros(12, np.int64),
                           max_new=8)])
    with pytest.raises(ValueError, match="SLA tier"):
        srv.serve([Request(uid=0, prompt=np.zeros(4, np.int64), sla="gold")])
    for strategy in ("masked", "gather"):
        # ported, sharded too; a shard grid the batch does not split is
        # refused up front
        Server(lm, _cfg(strategy), ServeConfig(), params, device="cpu")
        sharded = _cfg(strategy)
        sharded = sharded.replace(sparse=dataclasses.replace(
            sharded.sparse, tp_shards=2))
        Server(lm, sharded, ServeConfig(), params, device="cpu")
        sharded = sharded.replace(sparse=dataclasses.replace(
            sharded.sparse, dp_shards=3))
        with pytest.raises(ValueError, match="dp_shards"):
            Server(lm, sharded, ServeConfig(), params, device="cpu")
    with pytest.raises(NotImplementedError):
        Server(lm, cfg, ServeConfig(slot_refill=False), params, device="cpu")
