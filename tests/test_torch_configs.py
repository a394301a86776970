"""The port's configs against the reference's, field for field."""
import dataclasses

import pytest

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg

ARCH = "prosparse-llama2-7b"


@pytest.mark.parametrize("make", ["get_config", "reduced_config"])
def test_model_config_fields_equal(make):
    ref = getattr(jreg, make)(ARCH)
    port = getattr(treg, make)(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.vocab_padded == ref.vocab_padded
    assert port.resolved_head_dim == ref.resolved_head_dim


def test_registry_and_sla_tiers():
    assert ARCH in treg.arch_names()
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
