"""The placed dense model on gloo ranks of 1x4 (the heads, KV heads, MLP
rows and vocabulary split four ways; qwen3's and gemma2's 2 KV heads
shared by two ranks each, granite's one by all four) and 2x2 (two 'model'
lines, each holding what 1x2 holds, the slots split between the 'data'
lines: a rank's model runs its line's two of the four slots, and its
logits, stats, MLP inputs and int8 K/V codes are gathered over 'data'),
both laid over one spawn of four ranks:

- teacher-forced cases of ``tests/test_torch_mesh_place.py`` (``FORCED``;
  1x2 runs every one): every rank bitwise rank 0, rank 0 against one
  process within its tolerance, tokens and stats equal;
- against the JAX package on host-device meshes of the same shapes, at
  the reference's own mesh tolerance (``tests/test_distributed.py``'s
  decode step on a mesh: rtol 2e-3, atol 2e-4, greedy tokens equal): a
  prefill and one decode step with stats (reduced prosparse-llama2-7b,
  d_ff=512, norm scales drawn non-zero), masked on 1x4 and gather on 2x2,
  the ranks' logits against the JAX package's jitted steps under the
  mesh, the greedy tokens and every stat equal; ``Server(mesh=)`` on 1x4
  (gather, the controller with masked audits) against the JAX package's
  ``Server(mesh=)``, every request's tokens equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ControllerConfig as JControllerConfig
from repro.configs.registry import reduced_config as j_reduced
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.models import lm as jlm
from repro.runtime import server as jserver
from repro_torch import bridge
from repro_torch.configs.base import ControllerConfig
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import lm as tlm
from repro_torch.runtime.server import ServeConfig

import _torch_mesh_ranks as MR
from test_torch_mesh_place import arch, check_forced, forced_args, grid

ARCH = "prosparse-llama2-7b"
REF_TOL = dict(rtol=2e-3, atol=2e-4)
PROMPT = np.random.default_rng(41).integers(0, 512, (2, 8))
STEPS = {(1, 4): "masked", (2, 2): "gather"}
# the teacher-forced cases each mesh runs (1x2 runs every one): on 1x4
# the KV heads that do not split four ways (granite's one, qwen3's and
# gemma2's two), on 2x2 a 'data' axis under pallas, the QKV biases and a
# line's block-table rows on the paged kernels' route
FORCED = {(1, 4): ("granite mqa pallas paged-kernel",
                   "qwen3 qk-norm int8-weights chunk",
                   "gemma2 gather paged int8-pool"),
          (2, 2): ("7b pallas dense f32",
                   "qwen1.5 bias gather dense int8-kv",
                   "7b masked paged-kernel")}
SERVE_MESH = (1, 4)
REQS = [(i, np.random.default_rng(50 + i).integers(0, 512, size=6 + i), 5,
         "balanced") for i in range(3)]
IDS = ["1x4", "2x2"]


def _jcfg(cfg):
    """The JAX package's config of a port config of ``ARCH``."""
    jc = j_reduced(ARCH)
    sp = {f.name: getattr(cfg.sparse, f.name)
          for f in dataclasses.fields(cfg.sparse)
          if hasattr(jc.sparse, f.name)}
    return jc.replace(d_ff=cfg.d_ff, kv_cache_dtype=cfg.kv_cache_dtype,
                      sparse=dataclasses.replace(jc.sparse, **sp))


def _serve():
    cfg = grid(arch(ARCH, "gather"), SERVE_MESH)
    ccfg = dict(enabled=True, target_density=0.25, audit_period=3)
    return (cfg, ServeConfig(batch=2, max_len=32,
                             controller=ControllerConfig(**ccfg)),
            JControllerConfig(**ccfg))


@functools.lru_cache(maxsize=None)
def ranked() -> dict:
    """Every rank's ``MR.placed_cases`` of both meshes, one spawn of four
    ranks: on each its ``FORCED`` cases and the decode step, on 1x4 the
    server; {shape: [rank 0's, rank 1's, ...]}."""
    plan = []
    for shape in STEPS:
        serves = []
        if shape == SERVE_MESH:
            cfg, scfg, _ = _serve()
            serves = [(cfg, scfg, REQS)]
        plan.append((shape, forced_args(shape, FORCED[shape]),
                     [(grid(arch(ARCH, STEPS[shape]), shape), PROMPT)],
                     serves))
    outs = run_ranks(MR.placed_cases, SERVE_MESH, ("data", "model"),
                     args=(plan,), threads=1, timeout=240)
    return {shape: [o[i] for o in outs] for i, shape in enumerate(STEPS)}


def _jparams(cfg, perturb: bool):
    """The port's ``init_lm(cfg, 0)`` weights (``MR.perturbed`` scales
    when ``perturb``) as the JAX package's tree."""
    tp = tlm.init_lm(cfg, 0, "cpu", place=MR.perturbed() if perturb
                     else None)
    return jax.tree.map(jnp.asarray, bridge.params_to_numpy(tp, cfg))


@pytest.mark.parametrize("shape", list(STEPS), ids=IDS)
def test_forced_decode_matches_one_process(shape):
    check_forced(shape, [o["forced"] for o in ranked()[shape]],
                 FORCED[shape])


@pytest.mark.parametrize("shape", list(STEPS), ids=IDS)
def test_decode_step_matches_reference_mesh(shape):
    cfg = grid(arch(ARCH, STEPS[shape]), shape)
    jcfg = _jcfg(cfg)
    jp = jlm.prepare_sparse(_jparams(cfg, True), jcfg.sparse)
    toks = jnp.asarray(PROMPT, jnp.int32)

    def step(p):
        lg0, caches = jlm.prefill(p, jcfg, toks, max_len=MR.FORCED_MAX_LEN)
        lg, _, st = jlm.decode_step(p, jcfg, toks[:, -1:], caches,
                                    jnp.int32(toks.shape[1]),
                                    collect_stats=True)
        return lg0, lg, st
    with j_make_mesh(shape, ("data", "model")):
        want = jax.jit(step)(jp)
    outs = ranked()[shape]
    got = outs[0]["steps"][0]
    for r, o in enumerate(outs[1:], 1):
        np.testing.assert_array_equal(o["steps"][0]["logits"],
                                      got["logits"], err_msg=f"rank {r}")
    for name, g, w in (("prefill", got["prefill"], want[0]),
                       ("decode", got["logits"], want[1])):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, **REF_TOL, err_msg=name)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1),
                                      err_msg=name)
    assert set(got["stats"]) == set(want[2])
    for k, v in want[2].items():
        np.testing.assert_array_equal(got["stats"][k], np.asarray(v),
                                      err_msg=k)


def test_server_matches_reference_mesh_server():
    cfg, _, jccfg = _serve()
    jcfg = _jcfg(cfg)
    jsrv = jserver.Server(jlm, jcfg, jserver.ServeConfig(
        batch=2, max_len=32, controller=jccfg), _jparams(cfg, False),
        mesh=j_make_mesh(SERVE_MESH, ("data", "model")))
    done = jsrv.serve([jserver.Request(uid=u, prompt=p, max_new=m, sla=s)
                       for u, p, m, s in REQS])
    outs = ranked()[SERVE_MESH]
    got = outs[0]["serves"][0]["tokens"]
    assert set(got) == {r.uid for r in done}
    for r in done:
        np.testing.assert_array_equal(got[r.uid], np.asarray(r.out),
                                      err_msg=str(r.uid))
    for r, o in enumerate(outs[1:], 1):
        for uid, toks in o["serves"][0]["tokens"].items():
            np.testing.assert_array_equal(toks, got[uid],
                                          err_msg=f"rank {r} {uid}")
