"""``lm_loss`` and its backward for every registered arch through the
port against the JAX package's ``jax.value_and_grad(lm_loss)``, at
``reduced_config`` (float32) with ``remat`` off; ``tests/
test_torch_train_models_remat.py`` runs the same cases with it on.

The reference's weights come over through ``repro_torch.bridge``, with
the leaves that start at a value hiding a fault drawn at random on both
sides (norm scales and biases, QKV biases, zamba2's ``lora_b_q``, the
Mamba2 ``D``, ``dt_bias`` and conv biases, the vlm's cross gates).  The
batch (B=2, S=16, a few labels -100, frames or images for encdec and
vlm) is drawn with numpy; ``loss_chunk=6`` cuts the sequence in chunks of
4.  The loss is held within 1e-5 with ``xent`` and ``aux`` apart (``aux``
non-zero for the moe archs), and every gradient leaf, brought back to the
reference's stacked layout by ``bridge.params_to_numpy``, within 1e-4 x
the largest magnitude of the reference's leaf.  One value_and_grad of the
reference is built and run per arch and kept for the module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import arch_names
from repro.configs.registry import reduced_config as j_reduced
from repro.launch.specs import model_module as j_module
from repro_torch import bridge
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.launch.specs import model_module as t_module
from repro_torch.tree import flatten, unflatten

ARCHS = arch_names()
B, S = 2, 16
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4                       # x max |reference leaf|
PERTURB = ("scale", "bias", "lora_b_q", "conv_b", "bq", "bk", "bv",
           "gate_attn", "gate_mlp")


def cfgs(arch: str, remat: bool):
    return tuple(reduced(arch).replace(loss_chunk=6, remat=remat)
                 for reduced in (j_reduced, t_reduced))


def _perturb(node, rng) -> None:
    for k, v in sorted(node.items()):
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k in PERTURB:
            node[k] = (rng.standard_normal(v.shape) * 0.3).astype(v.dtype)
        elif k == "D":
            node[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        elif k == "dt_bias":
            node[k] = (v + rng.standard_normal(v.shape) * 0.3).astype(
                v.dtype)


def batch(cfg) -> dict:
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    out["labels"][0, :3] = -100
    out["labels"][1, -2] = -100
    if cfg.family == "vlm":
        out["images"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def weights(arch: str) -> dict:
    """The reference's initial weights (numpy leaves), perturbed."""
    jcfg, _ = cfgs(arch, False)
    tree = jax.tree.map(np.asarray, j_module(jcfg).init_lm(
        jax.random.PRNGKey(0), jcfg))
    _perturb(tree, np.random.default_rng(1))
    return tree


@functools.lru_cache(maxsize=None)
def reference(arch: str, remat: bool):
    """(loss, xent, aux, numpy gradient tree) of the JAX package."""
    jcfg, _ = cfgs(arch, remat)
    mod = j_module(jcfg)
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda p, bb: mod.lm_loss(p, jcfg, bb), has_aux=True))(
        jax.tree.map(jnp.asarray, weights(arch)),
        {k: jnp.asarray(v) for k, v in batch(jcfg).items()})
    return (float(loss), float(m["xent"]), float(m["aux"]),
            jax.tree.map(np.asarray, grads))


@functools.lru_cache(maxsize=None)
def port(arch: str, remat: bool):
    """(loss, xent, aux, gradient tree in the reference's layout) of the
    port on the reference's weights and batch."""
    _, tcfg = cfgs(arch, remat)
    params = bridge.params_from_numpy(weights(arch), tcfg, device="cpu")
    leaves = [p.requires_grad_(True) for _, p in flatten(params)]
    loss, m = t_module(tcfg).lm_loss(
        params, tcfg, {k: torch.from_numpy(v)
                       for k, v in batch(tcfg).items()})
    grads = unflatten(params, torch.autograd.grad(
        loss, leaves, allow_unused=True, materialize_grads=True))
    return (float(loss.detach()), float(m["xent"].detach()),
            float(m["aux"].detach()),
            bridge.params_to_numpy(grads, tcfg))


def check_loss(arch: str, remat: bool) -> None:
    jl, jx, ja = reference(arch, remat)[:3]
    tl, tx, ta = port(arch, remat)[:3]
    np.testing.assert_allclose(tx, jx, rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)
    assert (ja != 0.0) == (j_reduced(arch).family == "moe")


def check_grads(arch: str, remat: bool) -> None:
    want = reference(arch, remat)[3]
    got = port(arch, remat)[3]
    w_paths = jax.tree_util.tree_flatten_with_path(want)[0]
    g_leaves = jax.tree.leaves(got)
    assert len(w_paths) == len(g_leaves)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for (path, w), g in zip(w_paths, g_leaves):
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * scale if scale else 1e-9,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_reference(arch):
    check_loss(arch, remat=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    check_grads(arch, remat=False)
