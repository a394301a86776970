"""The vlm family through the port against the JAX package:
llama-3.2-vision-90b at its ``reduced_config`` (two groups of a self block
and a gated cross block, 8 image tokens), with the reference's weights
carried over by ``repro_torch.bridge``, the gates, norm scales and biases
drawn non-zero.  The harness and the tolerances are those of
``tests/test_torch_encdec.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import vision_lm as jvlm
from repro_torch import bridge
from repro_torch.launch.specs import model_module
from repro_torch.models import vision_lm as tvlm
from test_torch_encdec import (B, CHUNK, DECODE_CASES, _cfgs, _extra,
                               _params, _ref_tree, check_cache_helpers,
                               check_cli, check_decode_case,
                               check_entry_points_default_to_the_card, check_generate,
                               check_paged_refused, check_prefill_chunk,
                               check_prepare_sparse, check_serve,
                               check_sharded_decode)

FAM = "vlm"


def test_layout_and_bridge():
    """Layer g * p + j is ``self_blocks[g * (p - 1) + j]`` and layer g * p
    + p - 1 ``cross_blocks[g]``; the bridge carries the (n_groups,) gate
    leaves over as scalars, each non-zero."""
    jcfg, tcfg = _cfgs(FAM)
    tree = _ref_tree(FAM)
    tp = bridge.params_from_numpy(tree, tcfg, device="cpu")
    assert tcfg.cross_every == 2 and tcfg.n_layers == 4
    assert list(tvlm._layers(tcfg)) == [(0, "self", 0), (1, "cross", 0),
                                        (2, "self", 1), (3, "cross", 1)]
    assert len(tp["self_blocks"]) == len(tp["cross_blocks"]) == 2
    for g, blk in enumerate(tp["cross_blocks"]):
        for name in ("gate_attn", "gate_mlp"):
            assert blk[name].shape == ()
            assert float(blk[name]) == float(tree["cross_blocks"][name][g])
            assert abs(float(blk[name])) >= 0.3
    assert tuple(tp["cross_blocks"][0]["attn"]["wk"].shape) == (64, 32)
    assert model_module(tcfg) is tvlm
    init = tvlm.init_lm(tcfg, device="cpu")
    assert float(init["cross_blocks"][1]["gate_mlp"]) == 0.0
    with pytest.raises(ValueError, match="cross_every"):
        tvlm.init_lm(tcfg.replace(n_layers=5), device="cpu")
    with pytest.raises(ValueError, match="self_blocks"):
        bridge.params_from_numpy(tree, tcfg.replace(n_layers=6),
                                 device="cpu")


def test_gated_cross_blocks_reach_the_logits():
    """With the gates drawn non-zero the images move the logits; with the
    reference's zero gates they cannot (tanh(0) = 0)."""
    _, tcfg = _cfgs(FAM, "dense")
    tp = bridge.params_from_numpy(_ref_tree(FAM), tcfg, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab, size=(B, 6)))
    imgs = [torch.from_numpy(_extra(FAM, tcfg, B, s)) for s in (0, 1)]
    with torch.inference_mode():
        a, b = (tvlm.prefill(tp, tcfg, prompt, im, 8)[0] for im in imgs)
        assert not torch.allclose(a, b)
        for blk in tp["cross_blocks"]:
            blk["gate_attn"] = torch.zeros(())
            blk["gate_mlp"] = torch.zeros(())
        a, b = (tvlm.prefill(tp, tcfg, prompt, im, 8)[0] for im in imgs)
    assert torch.equal(a, b)


def test_images_project_in_float32_under_bf16_compute():
    """bf16 compute with float32 images: K/V project in float32, as jnp
    promotes mixed operands; the prefill's cross cache holds them."""
    jcfg, tcfg = _cfgs(FAM)
    jcfg, tcfg = (c.replace(dtype="bfloat16") for c in (jcfg, tcfg))
    jp, tp = _params(FAM, jcfg, tcfg, False)
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab, size=(B, 6))
    imgs = _extra(FAM, tcfg, B, 2)
    jl, jc = jvlm.prefill(jp, jcfg, jax.numpy.asarray(prompt),
                          jax.numpy.asarray(imgs), max_len=8)
    with torch.inference_mode():
        tl, tc = tvlm.prefill(tp, tcfg, torch.from_numpy(prompt),
                              torch.from_numpy(imgs), 8)
    assert tc["cross"][0]["k"].dtype == torch.float32
    assert np.asarray(jc["cross"]["k"]).dtype == np.float32
    np.testing.assert_allclose(tc["cross"][1]["v"].numpy(),
                               np.asarray(jc["cross"]["v"][1]), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_prefill_and_decode_teacher_forced(case):
    check_decode_case(FAM, case)


@pytest.mark.parametrize("mode", ["pallas", "dense"])
def test_prefill_chunk_teacher_forced(mode):
    check_prefill_chunk(FAM, mode)


def test_sharded_decode_matches_reference():
    check_sharded_decode(FAM)


@pytest.mark.parametrize("weights", ["", "int8"])
def test_prepare_sparse_every_block_list(weights):
    check_prepare_sparse(FAM, weights)


@pytest.mark.parametrize("chunk", [0, CHUNK])
def test_serve_matches_reference(chunk, monkeypatch):
    check_serve(FAM, chunk, monkeypatch)


def test_controller_serve_matches_reference(monkeypatch):
    check_serve(FAM, CHUNK, monkeypatch, ctrl=True,
                buckets=(0.25, 0.5, 1.0), d_ff=512)


def test_generate_matches_reference():
    check_generate(FAM)


def test_paged_kv_refused():
    check_paged_refused(FAM)


def test_cache_helpers_walk_every_list():
    check_cache_helpers(FAM)


def test_serve_cli_runs():
    check_cli(FAM)


def test_entry_points_default_to_the_card():
    check_entry_points_default_to_the_card(FAM)
