"""``models.lm`` with LayerNorm (``cfg.norm = "layernorm"``) for every
family it serves, against the reference's ``models/lm.py``, which picks
the norm by ``cfg.norm`` in every block (``models/common.py``).

Reduced dense (prosparse-llama2-7b), moe (deepseek-moe-16b: a dense first
layer, then MoE layers), hybrid (zamba2-1.2b) and xlstm (xlstm-125m)
configs with LayerNorm, sparsity off; the reference's weights carried
over by ``repro_torch.bridge``, every LayerNorm scale drawn as 1 + 0.3
N(0, 1) and every bias as 0.3 N(0, 1) (the reference starts them at 1
and 0).  Held: the LayerNorm leaves carried over unchanged, prefill logits
and two teacher-forced decode steps within 1e-4, and the training loss
within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as j_reduced
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.models import lm as tlm
from repro_torch.tree import flatten

ARCHS = {"dense": "prosparse-llama2-7b", "moe": "deepseek-moe-16b",
         "hybrid": "zamba2-1.2b", "xlstm": "xlstm-125m"}
B, PLEN, MAX_LEN = 2, 12, 24


def _cfgs(arch: str):
    return [r(arch).replace(norm="layernorm", sparse=dataclasses.replace(
        r(arch).sparse, enabled=False)) for r in (j_reduced, t_reduced)]


def _tree(jcfg) -> dict:
    tree = jax.tree.map(np.asarray,
                        jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(4)

    def perturb(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias"}:
                node["scale"] = (1 + 0.3 * rng.standard_normal(
                    node["scale"].shape)).astype(node["scale"].dtype)
                node["bias"] = (0.3 * rng.standard_normal(
                    node["bias"].shape)).astype(node["bias"].dtype)
            else:
                for v in node.values():
                    perturb(v)
    perturb(tree)
    return tree


@pytest.mark.parametrize("family", list(ARCHS))
def test_layernorm_lm_matches_reference(family):
    jcfg, tcfg = _cfgs(ARCHS[family])
    tree = _tree(jcfg)
    tparams = bridge.params_from_numpy(tree, tcfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    # every LayerNorm (a scale beside a bias) carried over as drawn
    biases = [v for p, v in flatten(tparams) if p[-1] == "bias"]
    assert len(biases) >= 3 and all(bool(b.abs().max() > 0) for b in biases)
    np.testing.assert_array_equal(tparams["final_norm"]["bias"].numpy(),
                                  tree["final_norm"]["bias"])
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, jcfg.vocab, size=(B, PLEN))
    forced = rng.integers(0, jcfg.vocab, size=(2, B, 1))
    jl, jc = jlm.prefill(jparams, jcfg, jnp.asarray(prompt), MAX_LEN)
    with torch.inference_mode():
        tl, tc = tlm.prefill(tparams, tcfg, torch.from_numpy(prompt),
                             MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    for t in range(2):
        jl, jc = jlm.decode_step(jparams, jcfg, jnp.asarray(forced[t]), jc,
                                 jnp.int32(PLEN + t))
        with torch.inference_mode():
            tl, tc = tlm.decode_step(tparams, tcfg,
                                     torch.from_numpy(forced[t]), tc,
                                     PLEN + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4, err_msg=f"step {t}")
    batch = {"tokens": prompt, "labels": np.roll(prompt, -1, axis=1)}
    jloss, _ = jlm.lm_loss(jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    tloss, _ = tlm.lm_loss(tparams, tcfg, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)

