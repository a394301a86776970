"""The port's sparse MLP (strategy ``pallas``) against the reference's
``pallas_mlp`` in interpret mode: the output and all six telemetry stats.

The stats derive from integer counts through the same float32 arithmetic,
so they are exact; y is held to rtol=atol=1e-5 (float32 sums in another
order; the reference's own drift reaches 1.4e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse_mlp as JSM
from repro_torch.core import sparse_mlp as TSM
from repro_torch.layers.mlp import mlp_apply

D, K = 128, 512
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    ref = JSM.SparseInferConfig(enabled=True, strategy="pallas",
                                activation="relu", group_size=8,
                                capacity_frac=0.1, **kw)
    port = TSM.SparseInferConfig(**dataclasses.asdict(ref))
    return ref, port


def _params(seed: int):
    params = JSM.prepare_sparse_params(JSM.init_gated_mlp(
        jax.random.PRNGKey(seed), D, K, dtype=jnp.float32))
    return params, {k: torch.from_numpy(np.array(v))
                    for k, v in params.items()}


@pytest.mark.parametrize("alpha", [1.0, 1.03, "per-slot+dead"])
@pytest.mark.parametrize("b", [1, 3])
def test_pallas_mlp_output_and_stats(alpha, b):
    ref_cfg, port_cfg = _cfgs()
    jp, tp = _params(0)
    x = np.random.default_rng(b).standard_normal((b, D)).astype(np.float32)
    a = (np.asarray([1.0, DEAD, 0.9][:b], np.float32)
         if alpha == "per-slot+dead" else np.float32(alpha))
    y_r, st_r = JSM.pallas_mlp(jp, jnp.asarray(x), ref_cfg,
                               alpha=jnp.asarray(a), interpret=True,
                               return_stats=True)
    y_p, st_p = TSM.pallas_mlp(tp, torch.from_numpy(x), port_cfg,
                               alpha=torch.as_tensor(a), return_stats=True)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
    assert set(st_p) == set(TSM.MLP_STAT_KEYS)
    for k in TSM.MLP_STAT_KEYS:
        np.testing.assert_array_equal(st_p[k].numpy(), np.asarray(st_r[k]),
                                      err_msg=k)


DEAD = TSM.DEAD_SLOT_ALPHA


def test_dense_mlp_and_single_token():
    ref_cfg, port_cfg = _cfgs()
    jp, tp = _params(1)
    x = np.random.default_rng(5).standard_normal((D,)).astype(np.float32)
    y_r, st_r = JSM.dense_mlp(jp, jnp.asarray(x), ref_cfg, return_stats=True)
    y_p, st_p = TSM.dense_mlp(tp, torch.from_numpy(x), port_cfg,
                              return_stats=True)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
    for k in TSM.MLP_STAT_KEYS:
        np.testing.assert_array_equal(st_p[k].numpy(), np.asarray(st_r[k]))
    # a 1-D token goes through the pallas strategy as a batch of one
    y1, st1 = TSM.pallas_mlp(tp, torch.from_numpy(x), port_cfg,
                             return_stats=True)
    assert y1.shape == (D,) and st1["predicted_density"].shape == ()


def test_mlp_apply_dense_fallback_past_sparse_max_batch():
    """More decode tokens than sparse_max_batch run the dense MLP — the
    reference's semantics (one union selection serves at most that many)."""
    _, port_cfg = _cfgs(sparse_max_batch=2)
    _, tp = _params(2)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, D)).astype(np.float32))
    y, st = mlp_apply(tp, x, port_cfg, decode=True, return_stats=True)
    y_d = TSM.dense_mlp(tp, x, port_cfg)
    torch.testing.assert_close(y, y_d, rtol=0, atol=0)
    assert float(st["union_demand_frac"][0]) == 1.0


@pytest.mark.parametrize("strategy", ["masked", "gather"])
def test_unported_strategies_raise(strategy):
    """masked and gather run (tests/test_torch_strategies.py), and so does
    their sharded formulation (held to the reference in
    tests/test_torch_distributed.py), with the per-shard riders; only the
    grouped (G, B, d) layout, which has no sharded form, raises."""
    _, port_cfg = _cfgs()
    _, tp = _params(3)
    y = TSM.apply(tp, torch.zeros((1, D)), dataclasses.replace(
        port_cfg, strategy=strategy))
    assert y.shape == (1, D)
    sharded = dataclasses.replace(port_cfg, strategy=strategy, tp_shards=2)
    y, st = TSM.apply(tp, torch.zeros((1, D)), sharded, return_stats=True)
    assert y.shape == (1, D)
    assert st[TSM.SHARD_STAT_KEY].shape == (1, 2)
    with pytest.raises(ValueError, match="tp_shards"):
        TSM.apply(tp, torch.zeros((2, 1, D)), sharded)
