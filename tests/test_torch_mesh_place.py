"""The dense model placed on a mesh of ranks: every leaf split by the serve
rules (``repro_torch/sharding/rules.py``), the attention by heads, the
caches by KV heads, the tables by vocabulary.

In one process (a ``RankMesh`` with a rank and no process group places as
that rank would): the port's ``param_spec`` against the JAX package's on
host-device meshes of the same shapes, every leaf of every rank of 1x2,
1x4 and 2x2 against the JAX package's slice of it under those specs
(``NamedSharding.devices_indices_map``), the attention's K/V leaves where
the KV heads do not split (MQA, and GQA with 2 KV heads over 4 ranks)
being the one documented difference, and each rank's bytes; the heads'
fallbacks; ``check_placed``.

On gloo ranks of the CPU (``tests/_torch_mesh_ranks.py:forced_cases``, one
spawn a placement): teacher-forced decode of reduced dense archs with
d_ff=512 (so the capacity clamp binds), norm scales and QKV biases drawn
non-zero, against the one-process model of
the same (dp_shards, tp_shards) grid, whose MLP calls take the ranks'
inputs of the same call and whose int8 K/V quantizations store the
ranks' codes (a value within rounding of a code boundary would otherwise
take the neighbouring code, 1/127 of its row's largest magnitude away)
after holding their own within one code step of them
(``MR.kv_codes``): logits within rtol = atol = 1e-5, every stat equal,
teacher-forced tokens equal, every rank bitwise rank 0.  This file runs
1x2; ``test_torch_mesh_place_2d.py`` 1x4 and 2x2, with the JAX package's
mesh decode step and mesh server.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from repro.launch.mesh import make_mesh as j_make_mesh
from repro.sharding import rules as JR
from repro_torch import bridge
from repro_torch.configs.registry import reduced_config
from repro_torch.launch.mesh import RankMesh, make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import lm as tlm
from repro_torch.sharding import rules as TR
from repro_torch.sharding import sparse as TSS
from repro_torch.tree import tree_bytes

import _torch_mesh_ranks as MR

D_FF = 512
# the logits' tolerance against one process, as the mesh MLP files hold
# theirs: the attention's and the head's sums run in another order.  The
# int8 KV cases are held to it too: with the ranks' codes replayed (and
# the one process's own codes equal to them) their logits read 0.95e-6 to
# 2.4e-6 from one process's on 1x2, 1x4 and 2x2, the float32 cases' range
TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
# the attention leaves that hold K/V heads
KV_LEAVES = ("wk", "wv", "bk", "bv")


def arch(name: str, strategy: str = "pallas", kv: str = "", **sp):
    """A reduced dense arch with d_ff=512 (64 row groups of 8, capacity
    0.5: the clamp binds) and ``strategy``; ``kv``: the KV cache dtype."""
    cfg = reduced_config(name)
    cfg = cfg.replace(d_ff=D_FF, sparse=dataclasses.replace(
        cfg.sparse, enabled=True, strategy=strategy, capacity_frac=0.5,
        quant_group_size=32, **sp))
    return cfg.replace(kv_cache_dtype=kv) if kv else cfg


def grid(cfg, shape: tuple):
    """``cfg`` with the semantic grid of a ('data', 'model') mesh."""
    return cfg.replace(sparse=dataclasses.replace(
        cfg.sparse, dp_shards=shape[0], tp_shards=shape[1]))


# (label, config, kind): every strategy, the dense cache, chunked prefill
# and the paged pool on both routes, float32 and int8 KV, MQA (granite:
# K=1), GQA with qk-norm (qwen3: K=2), QKV biases (qwen1.5), gemma2's
# softcaps, window, embedding scale and tied table, int8 MLP weights
CASES = (
    ("7b pallas dense f32", arch("prosparse-llama2-7b"), "dense"),
    ("7b gather chunk int8-kv", arch("prosparse-llama2-7b", "gather",
                                     "int8"), "chunk"),
    ("7b masked paged-kernel", arch("prosparse-llama2-7b", "masked")
     .replace(paged_attn_kernel=True), "paged"),
    ("granite mqa pallas paged-kernel", arch("granite-34b")
     .replace(paged_attn_kernel=True), "paged"),
    ("qwen1.5 bias gather dense int8-kv", arch("qwen1.5-32b", "gather",
                                               "int8"), "dense"),
    ("qwen3 qk-norm int8-weights chunk", arch(
        "qwen3-8b", weight_dtype="int8"), "chunk"),
    ("gemma2 gather paged int8-pool", arch("gemma2-2b", "gather", "int8"),
     "paged"),
)


# ------------------------------------------------------------ the rules --

def _leaves(tree, path=""):
    """(path, leaf) of every leaf, '/'-joined (a tuple is a leaf: a
    spec)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}" if path else str(i))
    elif tree is not None:
        yield path, tree


def _ref_path(path: str) -> tuple:
    """A port path -> (the reference's path, the layer or None): the
    reference stacks ``blocks/<i>/...`` along a leading axis."""
    parts = path.split("/")
    if parts[0] == "blocks":
        return "/".join(["blocks"] + parts[2:]), int(parts[1])
    return path, None


@functools.lru_cache(maxsize=None)
def _trees(name: str):
    """The whole prepared tree of a case's arch (int8 MLP weights for
    qwen3) and its reference-layout numpy copy."""
    cfg = dict((c.name, c) for _, c, _ in CASES)[name]
    whole = tlm.prepare_sparse(tlm.init_lm(cfg, 0, "cpu"), cfg.sparse)
    return cfg, whole, bridge.params_to_numpy(whole, cfg)


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_param_specs_match_reference(mesh_id):
    """``param_spec`` leaf for leaf equal to the JAX package's serve specs
    (``param_specs(..., "serve", mesh)``) on a host-device mesh of the
    same shape (its stacked leaves' leading None dropped), for every
    dense arch's prepared tree."""
    shape = MESHES[mesh_id]
    jm = j_make_mesh(shape, ("data", "model"))
    tm = make_mesh(shape, ("data", "model"))
    for name in dict.fromkeys(c.name for _, c, _ in CASES):
        _, whole, ref = _trees(name)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            JR.param_specs(ref, "serve", jm),
            is_leaf=lambda s: isinstance(s, PartitionSpec))
        ref_specs = {JR._path_str(kp): tuple(spec) for kp, spec in flat}
        for path, leaf in _leaves(whole):
            rpath, layer = _ref_path(path)
            got = TR.param_spec(path, tuple(leaf.shape), tm)
            ref_spec = ref_specs[rpath]
            if layer is not None:
                ref_spec = ref_spec[1:]
            assert got == ref_spec, (name, path, got, ref_spec)


def _ranks(shape: tuple) -> list:
    return [RankMesh(("data", "model"), shape, r)
            for r in range(int(np.prod(shape)))]


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_every_leaf_is_the_rule_slice(mesh_id):
    """Every rank's every leaf equals the whole leaf under the JAX
    package's serve spec for that rank's device, but the K/V leaves of an
    arch whose KV heads do not split over 'model': those hold the one KV
    head the rank's query heads read.  So a rank's bytes are the sum of
    its rule slices plus that replication only, and ``one_device_bytes``
    of a rank's part reads the whole tree's bytes."""
    shape = MESHES[mesh_id]
    jm = j_make_mesh(shape, ("data", "model"))
    m = shape[1]
    for name in dict.fromkeys(c.name for _, c, _ in CASES):
        cfg, whole, ref = _trees(name)
        ref_leaves = dict(_leaves(ref))
        hd = cfg.resolved_head_dim
        kv_split = cfg.n_kv_heads % m == 0
        for mesh in _ranks(shape):
            dev = jm.devices[tuple(mesh.coords()[a]
                                   for a in ("data", "model"))]
            placed = TSS.place_serve_params(whole, mesh, cfg)
            rule_bytes = extra = 0
            for path, leaf in _leaves(placed):
                rpath, layer = _ref_path(path)
                whole_leaf = ref_leaves[rpath]
                spec = JR.param_spec(rpath, whole_leaf.shape, "serve", jm)
                idx = NamedSharding(jm, spec).devices_indices_map(
                    whole_leaf.shape)[dev]
                want = whole_leaf[idx]
                want = want if layer is None else want[layer]
                rule_bytes += want.nbytes
                leaf_name = path.rsplit("/", 1)[-1]
                if leaf_name in KV_LEAVES and not kv_split:
                    head = (mesh.axis_index("model") // (m // cfg.n_kv_heads)
                            if m % cfg.n_kv_heads == 0 else 0)
                    full = whole_leaf if layer is None else whole_leaf[layer]
                    cols = slice(head * hd, (head + 1) * hd)
                    np.testing.assert_array_equal(
                        leaf.numpy(), full[..., cols], err_msg=path)
                    extra += leaf.numel() * leaf.element_size() - want.nbytes
                    continue
                np.testing.assert_array_equal(
                    bridge._numpy(leaf), want,
                    err_msg=f"{name} {mesh_id} rank {mesh.rank} {path}")
            assert tree_bytes(placed) == rule_bytes + extra, name
            assert TSS.one_device_bytes(placed, mesh, cfg) == \
                tree_bytes(whole), name
            if kv_split:
                assert extra == 0, name
            elif cfg.n_kv_heads == 1:     # MQA: K/V whole on every rank
                kv = sum(v.numel() * v.element_size()
                         for p, v in _leaves(whole)
                         if p.rsplit("/", 1)[-1] in KV_LEAVES)
                assert extra == kv - kv // m, name


def test_heads_and_cache_layout():
    """``attention_heads`` by whole heads, its fallbacks (the attention
    stays whole where the axis divides neither the query heads nor,
    either way, the KV heads), and the reference's
    ``kv_model_axis_entries`` without its head-dim fallback."""
    ranks = _ranks((1, 4))
    assert [TR.attention_heads(8, 8, r) for r in ranks][2] == \
        TR.HeadSplit(4, 6, 4, 6, 4)
    assert [(h.k0, h.k1) for h in (TR.attention_heads(8, 2, r)
                                   for r in ranks)] == [(0, 1), (0, 1),
                                                        (1, 2), (1, 2)]
    assert {TR.attention_heads(12, 1, r).k1 for r in ranks} == {1}
    for h, k in ((6, 6), (8, 3)):
        assert TR.attention_heads(h, k, ranks[1]) == TR.HeadSplit(
            0, h, 0, k, 1)
    assert TR.attention_heads(8, 8) == TR.HeadSplit(0, 8, 0, 8, 1)
    assert TR.kv_model_axis_entries(8, 16, ranks[0]) == ("model", None)
    assert TR.kv_model_axis_entries(2, 16, ranks[0]) == (None, None)
    assert TR.kv_model_axis_entries(8, 16, None) == (None, None)
    assert TR.attention_heads(8, 8, ranks[3]) == TR.HeadSplit(6, 8, 6, 8, 4)


def test_check_placed_and_cache_shapes():
    """``Server(mesh=)``'s check holds a placed tree and refuses a whole
    one or another mesh's; under the mesh ``init_caches`` and
    ``init_kv_pool`` hold the rank's KV heads, int8 scales too.  (Every
    rank's bytes against the whole tree's: ``test_every_leaf_is_the_rule_
    slice``.)"""
    cfg = grid(arch("qwen3-8b", kv="int8"), (1, 4))
    rank = _ranks((1, 4))[1]
    whole = tlm.init_lm(cfg, 0, "cpu")
    placed = TSS.place_serve_params(whole, rank, cfg)
    TSS.check_placed(placed, rank, cfg)
    TSS.check_placed(placed, RankMesh(("data", "model"), (1, 4)), cfg)
    with pytest.raises(ValueError, match="hidden rows"):
        TSS.check_placed(whole, rank, cfg)
    with pytest.raises(ValueError, match="embed/table"):
        TSS.check_placed(placed, _ranks((1, 2))[0], cfg)
    with TR.use_mesh(rank):
        caches = tlm.init_caches(cfg, 2, 16, "cpu")["blocks"][0]
        pool = tlm.init_kv_pool(cfg, 5, 8, "cpu")["blocks"][0]
    assert caches["k"].shape == (2, 16, 1, cfg.resolved_head_dim)
    assert caches["k_scale"].shape == (2, 16, 1)
    assert pool["v"].shape == (5, 8, 1, cfg.resolved_head_dim)


# ------------------------------------------------------ forced on ranks --

def forced_args(shape: tuple, labels=None) -> list:
    """``MR.forced_cases``'s cases (those of ``labels``; None: every one) of
    ``shape``'s grid."""
    return [(grid(cfg, shape), kind) for label, cfg, kind in CASES
            if labels is None or label in labels]


@functools.lru_cache(maxsize=None)
def ranked(shape: tuple) -> list:
    """Every case on the ranks of a ('data', 'model') mesh of ``shape``,
    one spawn."""
    return [o[0]["forced"] for o in run_ranks(
        MR.placed_cases, shape, ("data", "model"),
        args=([(shape, forced_args(shape), (), ())],), threads=1,
        timeout=240)]


def whole_codes(cfg, shape: tuple, outs: list, j: int) -> list:
    """The int8 K/V codes of every quantization of case ``j`` over all KV
    heads: the first 'model' line's ranks' codes of their heads, each KV
    head once (ranks that share one keep the same codes), in head order."""
    owners = {}
    for r in range(shape[1]):            # the ranks of data index 0
        split = TR.attention_heads(cfg.n_heads, cfg.n_kv_heads,
                                   RankMesh(("data", "model"), shape, r))
        owners.setdefault(split.k0, r)
    ranks = [owners[k] for k in sorted(owners)]
    return [tuple(np.concatenate([outs[r][j]["kv_codes"][i][n]
                                  for r in ranks], axis=-1 - (n == 0))
                  for n in range(2))
            for i in range(len(outs[0][j]["kv_codes"]))]


def one_process(cfg, kind: str, inputs: list, codes: list) -> dict:
    """``forced_steps`` in this process on the whole weights, every MLP call
    fed ``inputs`` and every int8 K/V quantization ``codes`` (the ranks'
    of the same call)."""
    params = tlm.prepare_sparse(tlm.init_lm(cfg, 0, "cpu",
                                           place=MR.perturbed()), cfg.sparse)
    pool = MR.whole_pool(cfg) if kind == "paged" else None
    replay, kv = list(inputs), list(codes)
    with MR.mlp_inputs(replay=replay), MR.kv_codes(replay=kv):
        out = MR.forced_steps(params, cfg, kind, pool)
    assert not replay and not kv, "fewer calls than on the ranks"
    return out


def check_forced(shape: tuple, outs: list, labels=None) -> None:
    """Every rank bitwise rank 0; rank 0 against one process: logits within
    ``TOL``, teacher-forced tokens and every stat equal.  ``outs``: each
    rank's ``MR.forced_cases`` of the cases of ``labels`` (None: every
    one)."""
    cases = [c for c in CASES if labels is None or c[0] in labels]
    for j, (label, cfg, kind) in enumerate(cases):
        cfg = grid(cfg, shape)
        got = outs[0][j]
        for r, o in enumerate(outs[1:], 1):
            np.testing.assert_array_equal(o[j]["logits"], got["logits"],
                                          err_msg=f"{label} rank {r}")
            for k, v in got["stats"].items():
                np.testing.assert_array_equal(o[j]["stats"][k], v,
                                              err_msg=f"{label} rank {r} {k}")
        want = one_process(cfg, kind, got["inputs"],
                           whole_codes(cfg, shape, outs, j))
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   err_msg=label, **TOL)
        np.testing.assert_array_equal(got["logits"].argmax(-1),
                                      want["logits"].argmax(-1),
                                      err_msg=label)
        assert set(got["stats"]) == set(want["stats"]), label
        for k, v in want["stats"].items():
            np.testing.assert_array_equal(got["stats"][k], v,
                                          err_msg=f"{label} {k}")


def test_forced_decode_matches_one_process_1x2():
    check_forced((1, 2), ranked((1, 2)))
