"""GPipe pipeline parallelism over a 'pipe' axis of ranks
(``repro_torch/sharding/pipeline.py``) against the JAX package's
``sharding/pipeline.py``: the reference's test stack (8 layers of
relu(x @ w), d=16, a batch of 12) streamed over 4 gloo ranks of the CPU,
each holding its stage of 2 layers, in 4, 6 and 12 microbatches: every
rank's output equal to rank 0's bit for bit and within 1e-5 of the
sequential stack and of the JAX ``pipeline_apply`` on 4 host devices;
``stage_params`` and ``bubble_fraction`` equal to the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_mesh as j_make_mesh
from repro.sharding import pipeline as JP
from repro_torch.launch.ranks import run_ranks
from repro_torch.sharding import pipeline as TP

import _torch_mesh_ranks as MR

N_LAYERS, D, B, STAGES = 8, 16, 12, 4
MICROBATCHES = [4, 6, 12]


def _inputs():
    ws = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                      (N_LAYERS, D, D)) * (D ** -0.5))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, D)))
    return ws.astype(np.float32), x.astype(np.float32)


def _j_block(w_stage, xm):
    def one(xm, w):
        return jax.nn.relu(xm @ w), None
    xm, _ = jax.lax.scan(one, xm, w_stage)
    return xm


def test_pipeline_matches_sequential_and_reference():
    ws, x = _inputs()
    outs = run_ranks(MR.pipeline_cases, (STAGES,), ("pipe",),
                     args=(ws, x, MICROBATCHES), timeout=300)
    seq = MR.pipe_block(torch.from_numpy(ws), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(seq, np.asarray(_j_block(ws, x)), rtol=0,
                               atol=1e-5)
    jm = j_make_mesh((STAGES,), ("pipe",))
    staged = JP.stage_params(jnp.asarray(ws), STAGES)
    for i, m in enumerate(MICROBATCHES):
        got = outs[0][i]
        for o in outs[1:]:
            np.testing.assert_array_equal(o[i], got)
        np.testing.assert_allclose(got, seq, rtol=0, atol=1e-5)
        with jm:
            ref = JP.pipeline_apply(_j_block, staged, jnp.asarray(x),
                                    mesh=jm, n_microbatches=m)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)


def test_stage_params_and_bubble_fraction_as_reference():
    ws, _ = _inputs()
    staged = TP.stage_params({"w": torch.from_numpy(ws)}, STAGES)["w"]
    np.testing.assert_array_equal(
        staged.numpy(), np.asarray(JP.stage_params(jnp.asarray(ws),
                                                   STAGES)))
    with pytest.raises(ValueError, match="stages"):
        TP.stage_params(torch.from_numpy(ws), 3)
    for s, m in ((4, 4), (1, 8), (4, 16), (2, 3), (8, 32)):
        assert TP.bubble_fraction(s, m) == JP.bubble_fraction(s, m)
