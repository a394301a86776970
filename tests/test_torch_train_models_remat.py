"""``lm_loss`` and its backward for every registered arch with
``remat=True``: each block under ``torch.utils.checkpoint`` in the port
(and ``jax.checkpoint`` in the reference), the Mamba2 chunks and the xLSTM
time steps under the sqrt-BPTT ``checkpointed_scan``.  The cases and
tolerances are ``tests/test_torch_train_models.py``'s; recomputation
changes no forward value, so the port's loss with remat equals its loss
without, bit for bit.
"""
import pytest

from test_torch_train_models import ARCHS, check_grads, check_loss, port


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_reference(arch):
    check_loss(arch, remat=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    check_grads(arch, remat=True)


@pytest.mark.parametrize("arch", ["prosparse-llama2-7b", "olmoe-1b-7b",
                                  "zamba2-1.2b", "xlstm-125m",
                                  "seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
def test_remat_changes_no_forward_value(arch):
    assert port(arch, True)[:3] == port(arch, False)[:3]
