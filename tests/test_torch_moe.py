"""The moe family through the port against the JAX package:
``layers/moe.py`` against ``repro/layers/moe.py``, and deepseek-moe-16b
(a dense first layer running the sparse MLP, MoE layers with 2 shared
experts) and olmoe-1b-7b (MoE layers only, qk-norm, unnormalised top-k)
at their ``reduced_config`` with the reference's weights carried over by
``repro_torch.bridge``: every entry point the dense archs run.

The layer.  Routing (each token's top-k expert ids) and the dispatch (the
sorted slot order and the kept-slot mask, overflow included) must be equal;
the output and the aux loss within 1e-5 in float32.  The reference's kept
mask is its own dispatch code's (``_ref_slots`` repeats its first lines).

The models.  As ``tests/test_torch_archs.py`` holds the dense archs:
teacher forced, logits within 1e-4 with a float32 KV cache and 5e-3 with
int8 KV; the MLP stats (layer 0's, the MoE layers' zeros) equal; a
server's tokens, controller report (floats to 1e-5), bucket sequence and
``paged_stats()`` equal.  The reference initialises norm scales at zero;
here they get seeded random values on both sides, so qk-norm acts.  At
``reduced_config`` the first layer's k=32 is 4 row groups, all selected;
the cases marked ``d_ff=512`` (64 groups, capacity 32) make the clamp bind
and give the bucket ladder its rungs (16/32/64 groups).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import moe as JM
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.core.sparse_mlp import SHARD_RIDER_KEYS
from repro_torch.kernels import ops
from repro_torch.layers import moe as TM
from repro_torch.models import lm as tlm
# the dense archs' harness, shared: configs, carried-over weights, the
# teacher-forced decode, stale pools and the controller-driven servers
from test_torch_archs import (B, CHUNK, NBPS, QG, STEPS, TOL, VALID,
                              _alphas, _cfgs, _fragmented, _params,
                              _prefill_decode, _random_pool, _ref_tree,
                              _same_stats, _serve_ctrl)

ARCHS = ("deepseek-moe-16b", "olmoe-1b-7b")


# ------------------------------------------------------------- the layer --

def _layer_cfgs(shared: int, norm: bool, act: str, cf: float):
    jc = JM.MoEConfig(d_model=64, d_expert=32, n_experts=8, top_k=2,
                      n_shared=shared, d_shared=32 * max(1, shared),
                      capacity_factor=cf, router_norm_topk=norm,
                      activation=act)
    return jc, TM.MoEConfig(**dataclasses.asdict(jc))


@functools.lru_cache(maxsize=None)
def _layer_params(shared: int, seed: int = 0):
    jc, _ = _layer_cfgs(shared, True, "silu", 1.25)
    tree = jax.tree.map(np.asarray, JM.init_moe(jax.random.PRNGKey(seed), jc))
    return tree


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _ref_slots(w, idx, cfg):
    """The first lines of the reference's ``_dispatch_compute``: the
    sorted slot order and the kept mask."""
    g, tg, k = idx.shape
    cap = JM._capacity(cfg, tg, cfg.n_experts)
    flat_e = idx.reshape(g, tg * k)
    flat_w = w.reshape(g, tg * k)
    order = jnp.argsort(flat_e.astype(jnp.float32) * 2.0
                        - flat_w * (1.0 - 1e-6), axis=-1)
    e_s = jnp.take_along_axis(flat_e, order, axis=-1)
    seg = jax.vmap(lambda es: jnp.searchsorted(
        es, jnp.arange(cfg.n_experts + 1)))(e_s)
    pos = jnp.arange(tg * k)[None] - jnp.take_along_axis(seg, e_s, axis=-1)
    return np.asarray(order), np.asarray(pos < cap), cap


SHAPES = {"2d": (48, 64), "3d": (2, 40, 64)}


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("act", ["relu", "silu"])
@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_moe_apply_matches_reference(shape, norm, shared, act, cf):
    """2-D input (one dispatch group) and 3-D (a group per sequence),
    router_norm_topk on and off, with and without 2 shared experts, relu
    and silu, and capacity_factor 0.25, where slots overflow: routing,
    the slot order and the kept slots equal; y and the aux loss within
    1e-5."""
    jc, tc = _layer_cfgs(shared, norm, act, cf)
    tree = _layer_params(shared)
    x = np.random.default_rng(1).standard_normal(SHAPES[shape]).astype(
        np.float32)
    jy, jaux = jax.jit(lambda p, x: JM.moe_apply(p, x, jc))(tree, x)
    ty, taux = TM.moe_apply(_torch_tree(tree), torch.from_numpy(x), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-5)
    xg = x.reshape((x.shape[0], -1, 64)) if x.ndim == 3 else x[None]
    probs, _ = JM.router_probs(tree, jnp.asarray(xg), jc)
    jw, jidx = JM._topk_route(probs, jc)
    tprobs, tw, tidx = TM.route(_torch_tree(tree), torch.from_numpy(x), tc)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs), rtol=0,
                               atol=1e-6)
    order, keep, cap = _ref_slots(jw, jidx, jc)
    sl = TM.dispatch_slots(tw, tidx, tc)
    assert sl.cap == cap
    np.testing.assert_array_equal(sl.order.numpy(), order)
    np.testing.assert_array_equal(sl.keep.numpy(), keep)
    if cf < 1.0:
        assert not keep.all()             # overflow happened: slots dropped
    if x.ndim == 3:
        assert ty.shape == x.shape


@pytest.mark.parametrize("n_tokens,top_k,cf,n_experts", [
    (1, 6, 1.25, 64), (1, 8, 1.25, 64), (64, 6, 1.25, 64), (64, 8, 1.25, 64),
    (10, 2, 4.0, 8), (37, 2, 0.25, 8), (200, 2, 1.0, 8), (0, 2, 1.25, 8)])
def test_capacity_matches_reference(n_tokens, top_k, cf, n_experts):
    kw = dict(d_model=64, d_expert=32, n_experts=n_experts, top_k=top_k,
              capacity_factor=cf)
    assert TM._capacity(TM.MoEConfig(**kw), n_tokens, n_experts) == \
        JM._capacity(JM.MoEConfig(**kw), n_tokens, n_experts)


@pytest.mark.parametrize("norm", [True, False])
def test_topk_ties_take_the_lower_index(norm):
    """Exactly tied probabilities: the lower expert index first, as
    ``lax.top_k`` orders them."""
    jc, tc = _layer_cfgs(0, norm, "silu", 1.25)
    probs = np.asarray([[0.1, 0.2, 0.2, 0.1, 0.1, 0.1, 0.1, 0.1],
                        [0.125] * 8,
                        [0.3, 0.1, 0.05, 0.3, 0.05, 0.05, 0.1, 0.05]],
                       np.float32)
    jw, jidx = JM._topk_route(jnp.asarray(probs), jc)
    tw, tidx = TM._topk_route(torch.from_numpy(probs), tc)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tidx.numpy(), [[1, 2], [0, 1], [0, 3]])
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-7)


def test_only_occupied_experts_run():
    """An expert with no kept slot is never read: NaN weights in it leave
    y finite and equal to the run with its real weights."""
    jc, tc = _layer_cfgs(0, True, "silu", 1.25)
    params = _torch_tree(_layer_params(0))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 1, 64)).astype(np.float32))
    _, _, idx = TM.route(params, x, tc)
    unused = sorted(set(range(8)) - set(idx.reshape(-1).tolist()))
    assert unused
    poisoned = dict(params)
    for name in ("wg_t", "wu_t", "wd_t"):
        poisoned[name] = params[name].clone()
        poisoned[name][unused] = float("nan")
    y0, _ = TM.moe_apply(params, x, tc)
    y1, _ = TM.moe_apply(poisoned, x, tc)
    assert torch.equal(y0, y1)


# ------------------------------------------------------------- the models --

def _ref_cache_layer(jc: dict, cfg, i: int) -> dict:
    """Layer ``i`` of the reference's cache tree (``first`` then
    ``blocks``)."""
    nf = cfg.first_dense_layers
    part, j = ("first", i) if i < nf else ("blocks", i - nf)
    return {name: np.asarray(buf[j]) for name, buf in jc[part].items()}


def test_layer_layout_and_bridge():
    """One block list in layer order: deepseek's layer 0 an MLP, the rest
    MoE with a shared expert; olmoe MoE throughout.  The bridge takes the
    reference's ``first_blocks``/``blocks`` into it leaf for leaf, and
    refuses a tree that does not match the config."""
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        tree = _ref_tree(arch)
        tp = bridge.params_from_numpy(tree, tcfg, device="cpu")
        nf = tcfg.first_dense_layers
        assert len(tp["blocks"]) == tcfg.n_layers == nf + 3
        assert [("mlp" in b, "moe" in b) for b in tp["blocks"]] == \
            [(i < nf, i >= nf) for i in range(tcfg.n_layers)]
        if nf:
            np.testing.assert_array_equal(
                tp["blocks"][0]["mlp"]["wg_t"].numpy(),
                tree["first_blocks"]["mlp"]["wg_t"][0])
        moe = tp["blocks"][-1]["moe"]
        assert ("shared" in moe) == bool(tcfg.n_shared_experts)
        np.testing.assert_array_equal(moe["wd_t"].numpy(),
                                      tree["blocks"]["moe"]["wd_t"][-1])
        assert tuple(moe["wg_t"].shape) == (8, 32, 64)
        with pytest.raises(ValueError, match="layers"):
            bridge.params_from_numpy(tree, tcfg.replace(
                n_layers=tcfg.n_layers + 1), device="cpu")
        init = tlm.init_lm(tcfg, 0, device="cpu")
        assert [set(b) for b in init["blocks"]] == \
            [set(b) for b in tp["blocks"]]
        assert tlm.has_sparse_mlp(tcfg) == bool(nf)
    with pytest.raises(ValueError, match="first_dense_layers"):
        bridge.params_from_numpy(_ref_tree("deepseek-moe-16b"),
                                 _cfgs("olmoe-1b-7b")[1], device="cpu")


@pytest.mark.parametrize("weights", ["float", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prepare_sparse_trees_match_reference(arch, weights):
    """``prepare_sparse`` leaf for leaf: every gated node's sign pack (the
    expert stacks' (E, f, d/32)), float expert stacks, and with int8
    weights the first layer's MLP and the shared expert quantized."""
    jcfg, tcfg = _cfgs(arch, "pallas", weight_dtype=(
        "int8" if weights == "int8" else ""), quant_group_size=QG)
    jp, tp = _params(arch, jcfg, tcfg, True)
    jtree = jax.tree.map(np.asarray, jp)
    nf = tcfg.first_dense_layers
    for i, blk in enumerate(tp["blocks"]):
        part, j = ("first_blocks", i) if i < nf else ("blocks", i - nf)
        ref_blk = jax.tree.map(lambda a: a[j], jtree[part])
        flat_t = {"/".join(map(str, p)): v for p, v in
                  _flatten(blk)}
        flat_j = {"/".join(map(str, p)): v for p, v in _flatten(ref_blk)}
        assert set(flat_t) == set(flat_j), set(flat_t) ^ set(flat_j)
        for name, v in flat_j.items():
            got = flat_t[name]
            assert got.dtype == getattr(torch, v.dtype.name), name
            np.testing.assert_array_equal(got.numpy(), v, err_msg=name)
    moe = tp["blocks"][-1]["moe"]
    assert moe["wg_t"].dtype == torch.float32
    assert tuple(moe["sign_wg"].shape) == (8, 32, 2)
    if weights == "int8" and "shared" in moe:
        assert moe["shared"]["wg_q"].dtype == torch.int8


def _flatten(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, node


def _decode_cases():
    out = [(a, m, "float32", 0) for a in ARCHS
           for m in ("pallas", "masked", "gather", "dense")]
    out += [(a, "pallas", "int8", 0) for a in ARCHS]
    out += [("deepseek-moe-16b", m, "float32", 512)
            for m in ("pallas", "gather")]
    return out


@pytest.mark.parametrize("arch,mode,kv,d_ff", _decode_cases())
def test_prefill_and_decode_teacher_forced(arch, mode, kv, d_ff):
    """A 10-token prefill (each prompt its own dispatch group), then 4
    decode steps at per-slot alphas (each slot a group of one token):
    strategies pallas, masked, gather and sparsity off, float32 and int8
    KV; ``d_ff=512`` binds the first layer's clamp.  The MoE layers' stats
    are zero.  Sparsity off runs without stats: the reference's dense
    first layer emits them per token (B, 1), which its concatenation with
    the MoE layers' (B,) refuses."""
    jcfg, tcfg = _cfgs(arch, mode, kv, d_ff=d_ff)
    jp, tp = _params(arch, jcfg, tcfg, mode != "dense", d_ff)
    nf = tcfg.first_dense_layers
    for st in _prefill_decode(jcfg, tcfg, jp, tp, TOL[kv],
                              stats=mode != "dense"):
        assert not any(bool(v[nf:].any()) for v in st.values())
        if nf:
            assert bool(st["realized_density"][0].gt(0).all())


@pytest.mark.parametrize("arch,kernel,kv", [
    (a, k, "float32") for a in ARCHS for k in (True, False)] + [
    (a, False, "int8") for a in ARCHS])
def test_paged_decode_teacher_forced(arch, kernel, kv):
    """4 decode steps from a fragmented pool of stale random content (the
    reference's ``first``/``blocks`` pool carried over by the bridge), the
    kernel route or the gather route; an int8 pool on the gather route:
    logits within the KV dtype's tolerance, stats equal."""
    jcfg, tcfg = _cfgs(arch, "pallas", kv, kernel)
    jp, tp = _params(arch, jcfg, tcfg, True)
    rng = np.random.default_rng(4)
    n_blocks, table = _fragmented(rng, B, NBPS)
    tree = _random_pool(rng, jcfg, n_blocks)
    jpool = jax.tree.map(jnp.asarray, tree)
    tpool = bridge.pool_from_numpy(tree, tcfg, device="cpu")
    assert len(tpool["blocks"]) == tcfg.n_layers
    lens0 = np.asarray([7, 9], np.int32)
    forced = rng.integers(0, jcfg.vocab, size=(STEPS, B, 1))
    alphas = _alphas(jcfg)
    jstep = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg,
                                      collect_stats=True))
    for t in range(STEPS):
        lens = lens0 + t
        jl, jpool, jst = jstep(jp, token=jnp.asarray(forced[t]),
                               caches=jpool, cache_len=jnp.asarray(lens),
                               alphas=jnp.asarray(alphas),
                               block_table=jnp.asarray(table))
        with torch.inference_mode():
            tl, tpool, tst = tlm.decode_step(
                tp, tcfg, torch.from_numpy(forced[t]), tpool,
                torch.from_numpy(lens), alphas=alphas, collect_stats=True,
                block_table=torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL[kv], err_msg=f"step {t}")
        _same_stats(tst, jst, f"step {t}")


@pytest.mark.parametrize("mode", ["pallas", "gather", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_teacher_forced(arch, mode):
    """A 3-chunk prompt through ``prefill_chunk`` with sparse prefill: the
    MoE layers route each sequence's chunk as a group, pad rows included
    (the last chunk holds pads in both rows): each chunk's logits within
    1e-4 and stats equal, the float32 KV cache within 1e-5."""
    jcfg, tcfg = _cfgs(arch, mode, sparse_prefill=True)
    jp, tp = _params(arch, jcfg, tcfg, mode != "dense")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab, size=(B, 3 * CHUNK))
    alphas = _alphas(jcfg)
    jc = jlm.init_caches(jcfg, B, 32)
    tc = tlm.init_caches(tcfg, B, 32, device="cpu")
    jchunk = jax.jit(functools.partial(jlm.prefill_chunk, cfg=jcfg,
                                       collect_stats=True))
    for off in range(0, 3 * CHUNK, CHUNK):
        piece = tokens[:, off:off + CHUNK]
        jl, jc, jst = jchunk(jp, tokens=jnp.asarray(piece), caches=jc,
                             offset=jnp.int32(off), valid=jnp.asarray(VALID),
                             alphas=jnp.asarray(alphas))
        with torch.inference_mode():
            tl, tc, tst = tlm.prefill_chunk(
                tp, tcfg, torch.from_numpy(piece), tc, off,
                torch.from_numpy(VALID), alphas=alphas, collect_stats=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL["float32"],
                                   err_msg=f"chunk at {off}")
        _same_stats(tst, jst, f"chunk at {off}")
    for i in range(tcfg.n_layers):
        want = _ref_cache_layer(jc, tcfg, i)
        for name, buf in tc["blocks"][i].items():
            np.testing.assert_allclose(buf.numpy(), want[name], rtol=0,
                                       atol=1e-5,
                                       err_msg=f"layer {i} {name}")


@pytest.mark.parametrize("strategy", ["pallas", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_weights_teacher_forced(arch, strategy):
    """int8 MLP weights (quant groups of 16): the first layer's MLP runs
    the int8 path, the shared expert its dequantized view, the expert
    stacks stay float.  Prefill and 4 decode steps: logits within 1e-4,
    stats equal."""
    jcfg, tcfg = _cfgs(arch, strategy, weight_dtype="int8",
                       quant_group_size=QG)
    jp, tp = _params(arch, jcfg, tcfg, True)
    _prefill_decode(jcfg, tcfg, jp, tp, TOL["float32"], seed=5)


# ------------------------------------------------------------ the server --

@pytest.mark.parametrize("strategy,paged", [
    ("pallas", False), ("pallas", True), ("gather", False), ("masked", True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch, strategy, paged):
    """The per-tier controller on dense caches and on a paged pool with a
    shared 8-token prefix (kernel route): the MoE layers' zero stats feed
    the controller as the JAX server's do (one alpha a layer)."""
    _serve_ctrl(arch, strategy, paged=paged, prefix=8 if paged else 0)


@pytest.mark.parametrize("weights", ["", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_bucket_ladder_matches_reference(arch, weights):
    """gather with masked audits every 4th step over a 3-rung ladder (16,
    32, 64 groups at d_ff=512), float and int8 weights: the bucket
    sequence the JAX server picks, and deepseek's moves between rungs."""
    _, tsrv = _serve_ctrl(arch, "gather", buckets=(0.25, 0.5, 1.0),
                          d_ff=512, weights=weights)
    if tlm.has_sparse_mlp(tsrv.cfg):
        assert set(tsrv.bucket_history) <= {16, 32, 64}
        assert len(set(tsrv.bucket_history)) > 1
    if weights and tlm.has_sparse_mlp(tsrv.cfg):
        assert tsrv.params["blocks"][0]["mlp"]["wg_q"].dtype == torch.int8


# ------------------------------------------------------------- sharding --

@pytest.mark.parametrize("strategy", ["masked", "gather", "pallas"])
def test_sharded_decode_riders_match_reference(strategy):
    """deepseek at tp_shards=2 (d_ff=512: 32 groups a shard): the first
    layer's per-shard riders stack against the MoE layers' zero riders
    (L, B, 2), equal to the reference's meshless emulation; logits within
    1e-4."""
    arch = "deepseek-moe-16b"
    jcfg, tcfg = _cfgs(arch, strategy, d_ff=512, tp_shards=2,
                       capacity_frac=0.25)
    jp, tp = _params(arch, jcfg, tcfg, True, 512)
    for st in _prefill_decode(jcfg, tcfg, jp, tp, TOL["float32"], seed=6,
                              riders=True):
        rider = st[SHARD_RIDER_KEYS[0]]
        assert tuple(rider.shape) == (tcfg.n_layers, B, 2)
        assert bool(rider[0].gt(0).any()) and not bool(rider[1:].any())


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_server_matches_reference(arch):
    """A tp_shards=2 server (pallas, per-tier controller, d_ff=512):
    tokens, report and bucket sequence equal the JAX server's; olmoe, with
    no sparse MLP layer, needs no shardable k."""
    _serve_ctrl(arch, "pallas", d_ff=512, n=4, tp_shards=2)


# ------------------------------------------------------------------ CLI --

@pytest.mark.parametrize("extra", [
    (), ("--strategy", "pallas", "--prefill-chunk", "8", "--sparse-prefill",
         "--weight-dtype", "int8", "--quant-group-size", "16"),
    ("--strategy", "gather", "--max-len", "32", "--paged-kv", "8",
     "--controller", "--per-tier")])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_arch(arch, extra):
    from repro_torch.launch import serve as serve_cli
    ops.reset_launch_counts()
    rep = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--requests", "2", "--batch", "2", "--max-new",
                          "4", "--prompt-len", "12", *extra])
    assert rep["completed"] == 2 and rep["tokens"] == 8
    assert sum(ops.launch_counts().values()) == 0       # plain on the CPU
