"""The sparse decode's shard grid placed on ranks: the port's
``shard_map_apply`` on gloo ranks of the CPU (``launch/ranks.py``, one
thread a rank) against its one-process ``emulated_apply``, bitwise, and
against the JAX package's ``shard_map_apply`` on host-device meshes of the
same shapes.  A rank gets its 'data' line's slots of a decode's x
(``rules.slot_range``) and gathers nothing over 'data' (its outputs are
gathered over 'data' afterwards, for the comparison).

The MLP is ``tests/test_torch_distributed.py``'s: d=128, k=512 (64 row
groups of 8), capacity_frac 0.1, so every shard's clamp binds.  The grid
(ds, ms) = (4, 4) runs on meshes 1x4, 4x1 (here) and 2x2, where a rank
loops over its tiles, and (1, 2) on 1x2 (``test_torch_mesh_apply_2d.py``);
B = 8 slots, alphas scalar or per token
with a dead slot, float32 and int8 (qg 16) weights, a heterogeneous
per-shard bucket tuple, the no-stats path and a prefill's dense MLP.  One
spawn a placement runs every case.  Against the ranks: y, every stat and the per-shard riders
equal (torch.equal), and each rank kept 1/m_mesh of the rows.  Against the
reference: integers equal, y within rtol = atol = 1e-5, as that file holds
the emulation.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_mesh as j_make_mesh
from repro.runtime import distributed as JDD
from repro_torch.core import sparse_mlp as TSM
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.ranks import choose_backend, run_ranks
from repro_torch.layers.mlp import mlp_apply
from repro_torch.runtime import distributed as TDD
from repro_torch.sharding import rules as TR
from repro_torch.sharding import sparse as TSS

import _torch_mesh_ranks as MR
from test_torch_distributed import D, DEAD, TOL, _mlp_params, _sparse_cfgs

B = 8
STRATEGIES = ("masked", "gather", "pallas")
# (mesh shape, axes, semantic grid (ds, ms))
PLACEMENTS = (((1, 4), ("data", "model"), (4, 4)),
              ((4, 1), ("data", "model"), (4, 4)),
              ((2, 2), ("data", "model"), (4, 4)),
              ((1, 2), ("data", "model"), (1, 2)))
IDS = ["1x4", "4x1", "2x2", "1x2"]
ALPHAS = {"scalar": np.float32(1.03),
          "per-token+dead": np.asarray([1.0, DEAD, 0.9, 1.1, 1.0, 1.03,
                                        0.95, 1.2], np.float32)}
X = np.random.default_rng(31).standard_normal((B, D)).astype(np.float32)
# a prefill's rows (2 sequences of 5): a sharded config's dense MLP
X3 = np.random.default_rng(32).standard_normal((2, 5, D)).astype(np.float32)


def _cases(grid: tuple) -> list:
    """(label, strategy, int8, reference config, port config, alpha,
    return_stats) of one placement."""
    ds, ms = grid
    out = []
    for strategy in STRATEGIES:
        for int8 in (False, True):
            for akind, a in ALPHAS.items():
                jc, tc = _sparse_cfgs(strategy, ds, ms)
                out.append((f"{strategy} {'int8' if int8 else 'f32'} "
                            f"{akind}", strategy, int8, jc, tc, a, True))
        jc, tc = _sparse_cfgs(strategy, ds, ms)
        out.append((f"{strategy} no stats", strategy, False, jc, tc,
                    ALPHAS["scalar"], False))
    for int8 in (False, True):
        jc, tc = _sparse_cfgs("pallas", ds, ms)
        out.append((f"dense prefill {'int8' if int8 else 'f32'}", "dense",
                    int8, jc, tc, None, True))
    caps = (2, 8, 4, 8)[:ms]
    for strategy in ("gather", "pallas"):
        jc, tc = _sparse_cfgs(strategy, ds, ms, shard_bucket_caps=caps,
                              capacity_override=max(caps) * ms)
        out.append((f"{strategy} caps {caps}", strategy, False, jc, tc,
                    ALPHAS["per-token+dead"], True))
    return out


@functools.lru_cache(maxsize=None)
def _ranked(i: int):
    """Every case of placement ``i`` on its ranks: (cases, each rank's
    outputs)."""
    shape, axes, grid = PLACEMENTS[i]
    cases = _cases(grid)
    args = [({k: v.numpy() for k, v in _mlp_params(0, int8)[1].items()},
             X3 if strategy == "dense" else X, a, tc, stats)
            for _, strategy, int8, _, tc, a, stats in cases]
    return cases, run_ranks(MR.apply_cases, shape, axes, args=(args,),
                            threads=1, timeout=240)


def check_bitwise_emulated(i: int) -> None:
    """Every rank returns what the one-process ``emulated_apply`` of the
    same grid returns, bit for bit, having kept 1/m_mesh of the rows."""
    shape, axes, _ = PLACEMENTS[i]
    cases, outs = _ranked(i)
    m_mesh = dict(zip(axes, shape)).get("model", 1)
    for j, (label, strategy, int8, _, tc, a, stats) in enumerate(cases):
        tp = _mlp_params(0, int8)[1]
        if strategy == "dense":
            want = mlp_apply(tp, torch.from_numpy(X3), tc, prefill=True,
                             return_stats=True)
        else:
            want = TDD.emulated_apply(tp, torch.from_numpy(X), tc, a,
                                      strategy=strategy,
                                      return_stats=stats)
        y, st = want if stats else (want, None)
        for r, out in enumerate(outs):
            o = out[j]
            msg = f"{IDS[i]} rank {r} {label}"
            assert torch.equal(torch.from_numpy(o["y"]), y), msg
            assert o["rows"] == 512 // m_mesh, msg
            # a decode's rows stay on their 'data' line
            assert o["axes"] == (["model"] if m_mesh > 1 else []), msg
            if not stats:
                assert o["stats"] is None, msg
                continue
            assert set(o["stats"]) == set(st), msg
            for k, v in st.items():
                assert torch.equal(torch.from_numpy(o["stats"][k]), v), \
                    f"{msg} {k}"


@functools.lru_cache(maxsize=None)
def _ref_on_mesh(shape: tuple, axes: tuple, strategy: str, cfg, stats):
    mesh = j_make_mesh(shape, axes)
    return jax.jit(lambda p, x, a: JDD.shard_map_apply(
        p, x, cfg, a, mesh=mesh, strategy=strategy, return_stats=stats))


def check_matches_reference(i: int) -> None:
    """The ranks' outputs against the JAX package's ``shard_map_apply`` on
    a host-device mesh of the same shape: integer stats and riders equal,
    y within the tolerance.  The per-token cases with a dead slot, float32
    and int8, and the bucket tuples."""
    shape, axes, _ = PLACEMENTS[i]
    cases, outs = _ranked(i)
    for j, (label, strategy, int8, jc, _, a, stats) in enumerate(cases):
        if not stats or "scalar" in label or strategy == "dense":
            continue
        jp = _mlp_params(0, int8)[0]
        y_r, st_r = _ref_on_mesh(shape, axes, strategy, jc, stats)(
            jp, jnp.asarray(X), jnp.asarray(a))
        o = outs[0][j]
        np.testing.assert_allclose(o["y"], np.asarray(y_r), **TOL,
                                   err_msg=label)
        assert set(o["stats"]) == set(st_r), label
        for k, v in st_r.items():
            np.testing.assert_array_equal(o["stats"][k], np.asarray(v),
                                          err_msg=f"{label} {k}")


# this file runs the 1x4 and 4x1 placements; test_torch_mesh_apply_2d.py
# the 2x2 and 1x2 ones (two files, so that each stays short on a worker)
@pytest.mark.parametrize("i", [0, 1], ids=IDS[:2])
def test_shard_map_apply_bitwise_emulated(i):
    check_bitwise_emulated(i)


@pytest.mark.parametrize("i", [0, 1], ids=IDS[:2])
def test_shard_map_apply_matches_reference(i):
    check_matches_reference(i)


def test_grid_checks_and_placement_in_process():
    """What needs no rank: the mesh of a shape alone, ``resolve_grid`` and
    ``sharded_apply`` against the reference's messages, the serve rules'
    spec of a sparse-MLP leaf and of a norm, the backend rule, and a mesh
    whose axes do not divide the grid."""
    mesh = make_mesh((2, 2), ("data", "model"))
    assert mesh.rank is None and mesh.size == 4
    assert TSS.mesh_shard_count(mesh) == TSS.mesh_data_count(mesh) == 2
    assert TSS.mesh_shard_count(None) == TSS.mesh_data_count(None) == 1
    with TR.use_mesh(make_mesh((4,), ("model",))):
        assert TSS.mesh_shard_count() == 4 and TSS.mesh_data_count() == 1
        with TR.shard_local():
            assert TR.current_mesh() is None
    assert TR.current_mesh() is None
    tc = TSM.SparseInferConfig(tp_shards=4, dp_shards=4)
    assert TSS.resolve_grid(tc, mesh, 8) == (4, 4)
    assert TSS.resolve_grid(TSM.SparseInferConfig(), mesh, 4) == (2, 2)
    for bad, batch, what in ((dict(tp_shards=3), 8, "'model'"),
                             (dict(dp_shards=3), 6, "'data'"),
                             (dict(dp_shards=4), 6, "batch 6")):
        with pytest.raises(ValueError, match=what):
            TSS.resolve_grid(TSM.SparseInferConfig(**bad), mesh, batch)
    assert TR.param_spec("mlp/wd_q", (512, 128), mesh) == ("model", None)
    assert TR.param_spec("mlp/sign_wg", (3, 512, 4), mesh) == (
        None, "model", None)
    assert TR.param_spec("ln_f/scale", (128,), mesh) == ()
    assert choose_backend(4, "cpu")[0] == "gloo"
    _, tc = _sparse_cfgs("gather", 3, 2)
    tp = _mlp_params(0, False)[1]
    with TR.use_mesh(make_mesh((2, 2), ("data", "model"))):
        with pytest.raises(ValueError, match="'data' axis has 2"):
            TSM.apply(tp, torch.zeros(6, D), tc, alpha=1.0)
        _, tc = _sparse_cfgs("gather", 2, 3)
        with pytest.raises(ValueError, match="'model' axis has 2"):
            TSM.apply(tp, torch.zeros(4, D), tc, alpha=1.0)
    with pytest.raises(ValueError, match="subsequence"):
        make_mesh((2, 2), ("model", "data"))
    assert TSS.serve_param_shardings(tp, None) == {k: None for k in tp}


@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
@pytest.mark.parametrize("ms", [2, 4])
def test_sharded_dense_mlp_matches_reference(ms, int8):
    """A tensor-sharded config's dense MLP (a prefill's rows), the shards'
    partials summed in fixed order: y within the tolerance of the
    reference's dense MLP, the stats (active rows counted per shard)
    equal, and the zero riders of the dense path."""
    from repro.layers.mlp import mlp_apply as j_mlp_apply
    jc, tc = _sparse_cfgs("pallas", 1, ms)
    jp, tp = _mlp_params(0, int8)
    y_r, st_r = jax.jit(lambda p, x: j_mlp_apply(
        p, x, jc, prefill=True, return_stats=True))(jp, jnp.asarray(X3))
    y_p, st_p = mlp_apply(tp, torch.from_numpy(X3), tc, prefill=True,
                          return_stats=True)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
    assert set(st_p) == set(st_r)
    for k, v in st_r.items():
        np.testing.assert_array_equal(st_p[k].numpy(), np.asarray(v),
                                      err_msg=k)
