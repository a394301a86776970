"""The shape matrix and its tools in the port against the reference's
(``repro/configs/base.py``, ``repro/launch/specs.py``,
``repro/launch/costs.py``).

- ``SHAPES`` and ``shape_applicable`` equal the reference's for every
  registered arch and shape, the skip reason word for word;
- at full size, for every registered arch (on ``meta``: no memory): the
  step inputs of every applicable shape, and the decode caches of the
  decode shapes, have the reference's shapes and dtypes
  (``jax.eval_shape``; the reference stacks layers, the port keeps one
  dict a layer), and the parameters the reference's element count per
  dtype;
- ``make_batch_specs`` gives a host's share of the batch on ``meta``;
- ``make_step_fn``'s train (one and two microbatches), prefill and decode
  steps at reduced dims give the reference's loss, grad norm, updated
  params and logits on the reference's weights.

``tests/test_torch_step_cost.py`` holds the steps' costs.
"""
import collections
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs.registry import arch_names as j_archs
from repro.configs.registry import get_config as j_get
from repro.configs.registry import reduced_config as j_reduced
from repro.launch import specs as JS
from repro.optim.adamw import init_adamw as j_init_adamw
from repro_torch import bridge
from repro_torch.configs import base as TB
from repro_torch.configs.registry import arch_names, get_config
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.data.pipeline import DataConfig, make_batch_specs
from repro_torch.launch import specs as TS
from repro_torch.optim.adamw import init_adamw
from repro_torch.tree import flatten, leaves


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "") if isinstance(
        dtype, torch.dtype) else np.dtype(dtype).name


def test_shapes_and_applicability_are_the_references():
    assert arch_names() == j_archs()
    assert {k: dataclasses.asdict(v) for k, v in TB.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JB.SHAPES.items()}
    for arch in arch_names():
        for name in TB.SHAPES:
            assert TB.shape_applicable(get_config(arch), TB.SHAPES[name]) \
                == JB.shape_applicable(j_get(arch), JB.SHAPES[name])
        assert get_config(arch).is_decoder_only == j_get(arch).is_decoder_only
        assert get_config(arch).supports_long_context == \
            j_get(arch).supports_long_context


def _port_layer_leaves(tree) -> collections.Counter:
    """(leaf name, per-layer shape, dtype) -> count over the port's
    per-layer tree."""
    out = collections.Counter()
    for path, leaf in flatten(tree):
        keys = [p for p in path if isinstance(p, str)]
        out[(_part(keys[0]), keys[-1], tuple(leaf.shape),
             _dt(leaf.dtype))] += 1
    return out


def _part(name: str) -> str:
    """A cache part's name: the reference's "self" is the port's
    "blocks"; a moe config's dense first layers ("first") are layers of
    "blocks" too."""
    return {"self": "blocks", "first": "blocks"}.get(name, name)


def _ref_layer_leaves(tree, rank: dict) -> collections.Counter:
    """The reference's stacked leaves cut to per-layer ones: the leading
    dims beyond the port's rank of that leaf name are layers."""
    out = collections.Counter()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        part, name = (_part(path[0].key),
                      getattr(path[-1], "key", None) or path[-1].name)
        lead = leaf.ndim - rank[(part, name)]
        out[(part, name, tuple(leaf.shape[lead:]), _dt(leaf.dtype))] += \
            math.prod(leaf.shape[:lead])
    return out


@pytest.mark.parametrize("arch", arch_names())
def test_full_size_inputs_caches_and_params_are_the_references(arch):
    jcfg, tcfg = j_get(arch), get_config(arch)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    for name, shape in TB.SHAPES.items():
        if not TB.shape_applicable(tcfg, shape)[0]:
            continue
        want = JS.input_specs(jcfg, JB.SHAPES[name], mesh)
        got = TS.input_specs(tcfg, shape)
        assert {k: (tuple(v.shape), _dt(v.dtype)) for k, v in got.items()} \
            == {k: (tuple(v.shape), _dt(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
        if shape.kind != "decode":
            continue
        jc = jax.eval_shape(functools.partial(
            JS.model_module(jcfg).init_caches, jcfg, shape.global_batch,
            shape.seq_len))
        tc = _port_layer_leaves(TS.cache_structs(tcfg, shape))
        rank = {k[:2]: len(k[2]) for k in tc}
        assert tc == _ref_layer_leaves(jc, rank), name
    jp = jax.eval_shape(functools.partial(JS.model_module(jcfg).init_lm,
                                          cfg=jcfg), jax.random.PRNGKey(0))
    want, got = collections.Counter(), collections.Counter()
    for leaf in jax.tree.leaves(jp):
        want[_dt(leaf.dtype)] += leaf.size
    for leaf in leaves(TS.param_shapes(tcfg)):
        got[_dt(leaf.dtype)] += leaf.numel()
    assert got == want


def test_make_batch_specs_is_a_hosts_share():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=8, n_hosts=2)
    extra = {"frames": torch.empty((4, 3, 5), device="meta")}
    got = make_batch_specs(cfg, extra)
    assert set(got) == {"tokens", "labels", "frames"}
    for k in ("tokens", "labels"):
        assert got[k].shape == (4, 16) and got[k].dtype == torch.int32
        assert got[k].device.type == "meta"


# ------------------------------------------------ step functions, reduced

S, B = 16, 2


def _pair(arch: str, **kw):
    jcfg = j_reduced(arch).replace(**kw)
    tcfg = t_reduced(arch).replace(**kw)
    tree = jax.tree.map(np.asarray, JS.model_module(jcfg).init_lm(
        jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, tree


def _batch(cfg, kind: str, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    width = 1 if kind == "decode" else S
    out = {"tokens": rng.integers(0, cfg.vocab, (B, width)).astype(np.int32)}
    if kind == "train":
        out["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    name = TS.extra_input_name(cfg)
    if name:
        n = cfg.n_image_tokens if name == "images" else cfg.n_frames
        out[name] = rng.standard_normal((B, n, cfg.d_model)).astype(
            np.float32)
    return out


def _to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).to(torch.bfloat16 if v.dtype.kind == "f"
                                      else torch.int32)
            for k, v in batch.items()}


def _to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype.kind == "f" else None)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch,micro", [("prosparse-llama2-7b", 1),
                                        ("prosparse-llama2-7b", 2),
                                        ("olmoe-1b-7b", 1),
                                        ("seamless-m4t-medium", 1)])
def test_train_step_matches_reference(arch, micro):
    jcfg, tcfg, tree = _pair(arch, microbatches=micro)
    shape = (JB.ShapeConfig("t", S, B, "train"),
             TB.ShapeConfig("t", S, B, "train"))
    batch = _batch(tcfg, "train")
    jp = jax.tree.map(jnp.asarray, tree)
    jp, _, jm = jax.jit(JS.make_step_fn(jcfg, shape[0]))(
        jp, j_init_adamw(jp), _to_jax(batch))
    tp = bridge.params_from_numpy(tree, tcfg, device="cpu")
    for p in leaves(tp):
        p.requires_grad_(True)
    tp, opt, tm = TS.make_step_fn(tcfg, shape[1])(tp, init_adamw(tp),
                                                  _to_torch(batch))
    assert opt.step == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    want = bridge.params_to_numpy(tp, tcfg)
    for (path, got), ref in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                jax.tree.leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=0,
                                   atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("arch", ["prosparse-llama2-7b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_prefill_and_decode_steps_match_reference(arch):
    jcfg, tcfg, tree = _pair(arch)
    jmod = JS.model_module(jcfg)
    jp = jmod.prepare_sparse(jax.tree.map(jnp.asarray, tree), jcfg.sparse)
    tp = TS.model_module(tcfg).prepare_sparse(
        bridge.params_from_numpy(tree, tcfg, device="cpu"), tcfg.sparse)
    for kind in ("prefill", "decode"):
        js, ts = (JB.ShapeConfig(kind, S, B, kind),
                  TB.ShapeConfig(kind, S, B, kind))
        batch = _batch(tcfg, kind, seed=1)
        jargs, targs = (jp, _to_jax(batch)), (tp, _to_torch(batch))
        if kind == "decode":
            jargs += (jmod.init_caches(jcfg, B, S),)
            targs += (TS.cache_structs(tcfg, ts, "cpu"),)
        jl, _ = JS.make_step_fn(jcfg, js)(*jargs)
        tl, _ = TS.make_step_fn(tcfg, ts)(*targs)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=5e-4, err_msg=kind)
