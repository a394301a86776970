"""Teacher-forced decode of reduced prosparse-llama2-7b (strategy pallas,
collect_stats) through the port against the reference, with the
reference's own weights carried over by ``repro_torch.bridge``.

Tokens are fed, not sampled, so both sides see the same inputs every step.
Tolerances: with a float32 KV cache the two sides differ only in float32
summation order (measured ~1e-6 on the logits here), held to 1e-4.  With the
int8 KV cache, q and p are rounded to bfloat16 before their products, where
a 1e-7 difference can move a value by one bf16 ulp (2^-8), so logits are
held to 5e-3.  Stats come from integer counts and must be equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as j_reduced
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.core.sparse_mlp import MLP_STAT_KEYS
from repro_torch.models import lm as tlm

ARCH = "prosparse-llama2-7b"
B, PLEN, STEPS, MAX_LEN = 2, 6, 4, 16


def _cfgs(kv: str):
    out = []
    for reduced in (j_reduced, t_reduced):
        cfg = reduced(ARCH)
        out.append(cfg.replace(kv_cache_dtype=kv, sparse=dataclasses.replace(
            cfg.sparse, strategy="pallas")))
    return out


@pytest.mark.parametrize("kv,tol", [("float32", 1e-4), ("int8", 5e-3)])
def test_decode_step_teacher_forced(kv, tol):
    jcfg, tcfg = _cfgs(kv)
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = tlm.prepare_sparse(bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    jparams = jlm.prepare_sparse(jparams)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jcfg.vocab, size=(B, PLEN))
    forced = rng.integers(0, jcfg.vocab, size=(STEPS, B, 1))
    alphas = (jcfg.sparse.alpha_schedule().alphas(jcfg.n_layers)[:, None]
              + np.asarray([0.25, -0.25], np.float32)[None, :])

    jstep = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg,
                                      collect_stats=True))
    jl, jc = jlm.prefill(jparams, jcfg, jnp.asarray(prompt), MAX_LEN)
    with torch.inference_mode():
        tl, tc = tlm.prefill(tparams, tcfg, torch.from_numpy(prompt),
                             MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    for t in range(STEPS):
        lens = np.full(B, PLEN + t, np.int32)
        jl, jc, jst = jstep(jparams, token=jnp.asarray(forced[t]), caches=jc,
                            cache_len=jnp.asarray(lens),
                            alphas=jnp.asarray(alphas))
        with torch.inference_mode():
            tl, tc, tst = tlm.decode_step(
                tparams, tcfg, torch.from_numpy(forced[t]), tc,
                torch.from_numpy(lens), alphas=alphas, collect_stats=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=tol, err_msg=f"step {t}")
        assert set(tst) == set(MLP_STAT_KEYS)
        for k in MLP_STAT_KEYS:
            assert tst[k].shape == (tcfg.n_layers, B)
            np.testing.assert_array_equal(tst[k].numpy(),
                                          np.asarray(jst[k]),
                                          err_msg=f"step {t} {k}")


def test_static_schedule_and_scalar_cache_len():
    """No alphas (static per-layer schedule), one shared cache length, the
    dense strategy: the same logits as the reference."""
    jcfg, tcfg = _cfgs("float32")
    jcfg = jcfg.replace(sparse=dataclasses.replace(jcfg.sparse,
                                                   enabled=False))
    tcfg = tcfg.replace(sparse=dataclasses.replace(tcfg.sparse,
                                                   enabled=False))
    jparams = jlm.init_lm(jax.random.PRNGKey(1), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab,
                                               size=(B, PLEN))
    tok = np.zeros((B, 1), np.int64)
    _, jc = jlm.prefill(jparams, jcfg, jnp.asarray(prompt), MAX_LEN)
    jl, _ = jlm.decode_step(jparams, jcfg, jnp.asarray(tok), jc,
                            jnp.int32(PLEN))
    with torch.inference_mode():
        _, tc = tlm.prefill(tparams, tcfg, torch.from_numpy(prompt), MAX_LEN)
        tl, _ = tlm.decode_step(tparams, tcfg, torch.from_numpy(tok), tc,
                                PLEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)


@pytest.mark.parametrize("flavour", [
    pytest.param({"norm": "layernorm"}, id="flavour1")])
def test_unported_model_flavours_raise(flavour):
    """Once refused, now ported: the flavour (LayerNorm in ``models.lm``)
    runs, and its prefill and teacher-forced decode match the reference's
    on the reference's weights, LayerNorm scales and biases drawn
    non-zero (tests/test_torch_layernorm.py holds every family)."""
    jcfg, tcfg = (c.replace(**flavour) for c in _cfgs("float32"))
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(5)
    for blk in (tree["blocks"]["ln1"], tree["blocks"]["ln2"],
                tree["final_norm"]):
        blk["scale"] = (1 + 0.3 * rng.standard_normal(
            blk["scale"].shape)).astype(np.float32)
        blk["bias"] = (0.3 * rng.standard_normal(
            blk["bias"].shape)).astype(np.float32)
    tparams = tlm.prepare_sparse(bridge.params_from_numpy(tree, tcfg,
                                                          device="cpu"))
    jparams = jlm.prepare_sparse(jax.tree.map(jnp.asarray, tree))
    prompt = rng.integers(0, jcfg.vocab, size=(B, PLEN))
    tok = rng.integers(0, jcfg.vocab, size=(B, 1))
    jl, jc = jlm.prefill(jparams, jcfg, jnp.asarray(prompt), MAX_LEN)
    with torch.inference_mode():
        tl, tc = tlm.prefill(tparams, tcfg, torch.from_numpy(prompt),
                             MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    jl, _ = jlm.decode_step(jparams, jcfg, jnp.asarray(tok), jc,
                            jnp.int32(PLEN))
    with torch.inference_mode():
        tl, _ = tlm.decode_step(tparams, tcfg, torch.from_numpy(tok), tc,
                                PLEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)


def test_bridge_unstacks_layers_and_rejects_depth_mismatch():
    jcfg, tcfg = _cfgs("float32")
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(2), jcfg))
    params = bridge.params_from_numpy(tree, tcfg, device="cpu")
    assert len(params["blocks"]) == tcfg.n_layers
    np.testing.assert_array_equal(params["blocks"][1]["mlp"]["wg_t"].numpy(),
                                  tree["blocks"]["mlp"]["wg_t"][1])
    with pytest.raises(ValueError, match="layers"):
        bridge.params_from_numpy(tree, tcfg.replace(n_layers=3),
                                 device="cpu")
