"""The port's configs against the reference's, field for field."""
import dataclasses

import pytest

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg

ARCH = "prosparse-llama2-7b"
# the dense, moe, encdec, vlm, hybrid and xlstm families: every arch the
# port registers, which is every arch of the reference
ARCHS = ("prosparse-llama2-7b", "prosparse-llama2-13b", "qwen3-8b",
         "qwen1.5-32b", "granite-34b", "gemma2-2b", "deepseek-moe-16b",
         "olmoe-1b-7b", "seamless-m4t-medium", "llama-3.2-vision-90b",
         "zamba2-1.2b", "xlstm-125m")
CROSS_ARCHS = ("seamless-m4t-medium", "llama-3.2-vision-90b")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("make", ["get_config", "reduced_config"])
def test_model_config_fields_equal(make, arch):
    ref = getattr(jreg, make)(arch)
    port = getattr(treg, make)(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.vocab_padded == ref.vocab_padded
    assert port.resolved_head_dim == ref.resolved_head_dim


def test_registry_and_sla_tiers():
    assert treg.arch_names() == sorted(ARCHS)
    assert treg.arch_names() == jreg.arch_names()
    assert [dataclasses.asdict(t) for t in tbase.DEFAULT_SLA_TIERS] == \
        [dataclasses.asdict(t) for t in jbase.DEFAULT_SLA_TIERS]
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")


@pytest.mark.parametrize("kw", [
    {}, {"capacity_frac": 0.1}, {"capacity_frac": 0.5, "group_size": 4},
    {"capacity_override": 7}, {"capacity_buckets": (0.125, 0.25, 0.5)}])
def test_capacity_and_alpha_schedule(kw):
    ref = dataclasses.replace(jreg.default_sparse(), **kw)
    port = dataclasses.replace(treg.default_sparse(), **kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for k in (128, 512, 11008):
        assert port.capacity(k) == ref.capacity(k)
        assert port.capacity_ladder(k) == ref.capacity_ladder(k)
    for n in (2, 32):
        assert port.alpha_schedule().alphas(n).tolist() == \
            ref.alpha_schedule().alphas(n).tolist()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("make", ["get_config", "reduced_config"])
def test_param_counts_equal(make, arch):
    """``d_expert``, ``param_count`` and ``active_param_count`` (the moe
    branches count the expert stacks, the router and the shared experts;
    the active count only the routed top-k and the shared)."""
    ref = getattr(jreg, make)(arch)
    port = getattr(treg, make)(arch)
    assert port.d_expert == ref.d_expert
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    if port.family == "moe":
        assert port.active_param_count() < port.param_count()


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_cross_family_fields(arch):
    """The fields the cross-attention families read: seamless-m4t-medium
    with LayerNorm, an ungated ReLU FFN, 12 + 12 layers and 1024 frames;
    llama-3.2-vision-90b with a cross layer every 5 of its 100 and 1600
    image tokens; reduced, the reference's cuts."""
    port, red = treg.get_config(arch), treg.reduced_config(arch)
    if port.family == "encdec":
        assert (port.norm, port.gated_mlp, port.activation) == \
            ("layernorm", False, "relu")
        assert (port.n_enc_layers, port.n_layers, port.n_frames) == \
            (12, 12, 1024)
        assert (red.n_enc_layers, red.n_layers, red.n_frames) == (2, 2, 16)
    else:
        assert (port.cross_every, port.n_layers, port.n_image_tokens) == \
            (5, 100, 1600)
        assert (port.d_model, port.d_ff) == (8192, 28672)
        assert (red.cross_every, red.n_layers, red.n_image_tokens) == \
            (2, 4, 8)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_kernel_plans_take_the_cross_widths(arch):
    """The kernels' host plans at the new widths on an H100's figures
    (seamless: d=1024, k=4096, 512 groups; the vlm: d=8192, the widest d
    a kernel has met, k=28672, 3584 groups), each at its capacity of 20%
    in groups of 8: the decode MLP (B in 1, 4, 16) within the shared
    memory limit, the int8 decode MLP (qg 128), the chunk MLPs (S=64,
    float32 and bf16 x, float32 and int8 weights), the predictors (B=4,
    S=64, the counts kernel) and the sign pack."""
    from repro_torch.core import predictor as P
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import sign_pack as KS
    from repro_torch.kernels import sparse_mlp_fused as KF
    from test_torch_chunk_mlp_tc import H100 as CHUNK_H100, SMS
    from test_torch_decode_mlp import H100 as DECODE_H100
    from test_torch_decode_mlp_q import H100 as DECODE_Q_H100
    from test_torch_predict_hopper import _card

    cfg = treg.get_config(arch)
    d, k, g = cfg.d_model, cfg.d_ff, cfg.sparse.group_size
    cap_rows = cfg.sparse.capacity(k) * g
    for b in (1, 4, 16):
        pl = KF.decode_plan(b, d, cap_rows, g, SMS, DECODE_H100)
        assert pl.smem_bytes <= 232448
        KF.decode_q_plan(b, d, cap_rows, g, 128, SMS, DECODE_Q_H100)
    for x_elem in (4, 2):
        KF.plan(64, d, cap_rows, x_elem, SMS, CHUNK_H100)
        KF.plan(64, d, cap_rows, x_elem, SMS, CHUNK_H100, w_elem=1,
                group_size=g)
    w = P.packed_width(d)
    for s in (4, 64):
        KP.margins_plan(s, w, k, g, _card(15))
    KP.margins_plan(4, w, k, 1, _card(15), counts=True)
    for rows, elem in ((k, 4), (4, 4), (4, 2), (64, 2)):
        KS.plan(rows, d, elem, 0)
