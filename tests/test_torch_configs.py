"""The port's configs against the reference's, field for field."""
import dataclasses

import pytest

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg

ARCH = "prosparse-llama2-7b"
# the dense and moe families: every arch the port registers
ARCHS = ("prosparse-llama2-7b", "prosparse-llama2-13b", "qwen3-8b",
         "qwen1.5-32b", "granite-34b", "gemma2-2b", "deepseek-moe-16b",
         "olmoe-1b-7b")


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
    assert set(treg.arch_names()) <= set(jreg.arch_names())
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
