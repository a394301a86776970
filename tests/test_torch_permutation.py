"""The offline co-activation permutation in the port against the
reference's (``repro/core/selection.py``).

- ``coactivation_permutation`` equals the reference's bit for bit on
  i.i.d., correlated (a hot set and a cold tail) and bool/int/float
  calibration matrices, ties included;
- ``apply_neuron_permutation`` equals the reference's leaf for leaf
  (float32 and bfloat16 weights; other leaves, a stale sign pack too, kept
  as they are);
- a permuted dense MLP computes the unpermuted one within 1e-6, and after
  ``prepare_sparse_params`` again its sign pack is the packed permuted
  rows and the sparse strategies select the permuted groups;
- on correlated activations the permutation lowers the group density, as
  the reference's ``group_permutation_study`` shows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as JS
from repro_torch.core import selection as TS
from repro_torch.core import sparse_mlp as SM
from repro_torch.kernels import ops


def _acts(kind: str, n: int = 128, k: int = 512, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "iid":
        return rng.random((n, k)) < 0.1
    acts = rng.random((n, k)) < 0.01
    hot = rng.permutation(k)[: k // 12]
    acts[:, hot] |= rng.random((n, len(hot))) < 0.9
    if kind == "ties":               # whole columns equal: frequency ties
        acts[:, 1::2] = acts[:, ::2]
    return acts


@pytest.mark.parametrize("kind", ["iid", "correlated", "ties"])
@pytest.mark.parametrize("dtype", [bool, np.int32, np.float32])
def test_permutation_is_the_references_bitwise(kind, dtype):
    acts = _acts(kind).astype(dtype)
    want = JS.coactivation_permutation(acts)
    got = TS.coactivation_permutation(acts)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(acts.shape[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_matches_reference(dtype):
    gen = torch.Generator().manual_seed(1)
    params = SM.prepare_sparse_params(SM.init_gated_mlp(gen, 64, 256))
    params = {k: (v.to(dtype) if v.is_floating_point() else v)
              for k, v in params.items()}
    perm = TS.coactivation_permutation(_acts("correlated", k=256))
    got = TS.apply_neuron_permutation(params, perm)
    jparams = {k: jnp.asarray(v.float().numpy()) for k, v in params.items()}
    want = JS.apply_neuron_permutation(jparams, perm)
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(want[name]), err_msg=name)
        assert got[name].dtype == params[name].dtype
    assert got["sign_wg"] is params["sign_wg"]          # stale, kept as is


def test_permuted_mlp_is_the_same_function():
    gen = torch.Generator().manual_seed(2)
    d, k = 64, 512
    params = SM.init_gated_mlp(gen, d, k)
    x = torch.randn((5, d), generator=gen)
    cfg = SM.SparseInferConfig(enabled=True, strategy="masked",
                               activation="relu", group_size=8,
                               capacity_frac=0.5)
    acts = (x @ params["wg_t"].T > 0).numpy()
    perm = TS.coactivation_permutation(acts)
    permuted = TS.apply_neuron_permutation(params, perm)
    torch.testing.assert_close(SM.dense_mlp(permuted, x, cfg),
                               SM.dense_mlp(params, x, cfg), rtol=0,
                               atol=1e-6)
    prepped = SM.prepare_sparse_params(permuted, cfg)
    torch.testing.assert_close(prepped["sign_wg"],
                               ops.sign_pack(permuted["wg_t"]))
    torch.testing.assert_close(
        prepped["sign_wg"],
        SM.prepare_sparse_params(params, cfg)["sign_wg"][torch.from_numpy(
            perm).long()])
    # the same rows are predicted live, at their new places
    for strategy in ("masked", "pallas"):
        c = SM.SparseInferConfig(enabled=True, strategy=strategy,
                                 activation="relu", group_size=1,
                                 capacity_frac=1.0)
        y_perm = SM.apply(SM.prepare_sparse_params(permuted, c), x, c)
        y = SM.apply(SM.prepare_sparse_params(params, c), x, c)
        torch.testing.assert_close(y_perm, y, rtol=0, atol=1e-5,
                                   msg=strategy)


def test_permutation_lowers_group_density():
    acts = _acts("correlated", n=256, k=1024, seed=3)

    def group_density(a, g=8):
        return float(a.reshape(a.shape[0], -1, g).any(-1).mean())
    perm = TS.coactivation_permutation(acts[:128])
    assert group_density(acts[128:][:, perm]) < 0.5 * group_density(
        acts[128:])
