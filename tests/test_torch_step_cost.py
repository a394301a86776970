"""``launch/costs.py:step_cost`` against the reference's cost walk and
against real runs.

- the train step's matmul FLOPs (``step_cost`` on ``meta``, remat off and
  on) equal the reference's ``jaxpr_cost`` for reduced qwen3-8b; on a
  miss the message names the port's FLOPs by op;
- ``step_cost`` on ``meta`` (a loop's first and last steps as they are,
  its second standing for the ones between) equals a real CPU run's
  matmul FLOPs by op, bytes, gather and scatter bytes for the dense,
  hybrid, xlstm, encdec and vlm families (a moe layer's dispatch depends
  on the routing, which ``meta`` does not have: there its rows spread
  evenly over the experts).
"""
import jax
import jax.numpy as jnp
import pytest

from repro.configs import base as JB
from repro.configs.registry import reduced_config as j_reduced
from repro.launch import specs as JS
from repro.launch.costs import jaxpr_cost
from repro.optim.adamw import init_adamw as j_init_adamw
from repro_torch.configs import base as TB
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.launch import costs as TC
from repro_torch.launch import dryrun as TD

S, B = 16, 2


@pytest.mark.parametrize("remat", [False, True])
def test_train_flops_equal_reference(remat):
    arch = "qwen3-8b"
    jcfg = j_reduced(arch).replace(remat=remat)
    tcfg = t_reduced(arch).replace(remat=remat)
    jshape = JB.ShapeConfig("t", S, B, "train")
    jp = JS.model_module(jcfg).init_lm(jax.random.PRNGKey(0), jcfg)
    tok = jnp.zeros((B, S), jnp.int32)
    want = jaxpr_cost(JS.make_step_fn(jcfg, jshape), jp, j_init_adamw(jp),
                      {"tokens": tok, "labels": tok})
    step, args, _ = TD.build(tcfg, TB.ShapeConfig("t", S, B, "train"))
    got = TC.step_cost(step, *args)
    assert got["dot_flops"] == want["dot_flops"], (
        f"port {got['dot_flops']} by op {got['flops_by_op']}, reference "
        f"dot_general {want['dot_flops']}")


@pytest.mark.parametrize("arch,kind", [
    ("prosparse-llama2-7b", "train"), ("prosparse-llama2-7b", "prefill"),
    ("prosparse-llama2-7b", "decode"), ("zamba2-1.2b", "train"),
    ("zamba2-1.2b", "prefill"),
    ("xlstm-125m", "train"), ("xlstm-125m", "prefill"),
    ("seamless-m4t-medium", "train"), ("llama-3.2-vision-90b", "train")])
def test_meta_cost_is_a_real_runs(arch, kind):
    """Sequence 40: loops of more than three steps (attention blocks of 8,
    Mamba2 chunks, xLSTM time steps, their checkpointed chunks) run their
    meta rule; remat on.  Elementwise FLOPs and the live-bytes peak are
    not held: autograd's gradient sums between a loop's steps and the
    tensors one loop step frees for the next are not scaled."""
    cfg = t_reduced(arch).replace(remat=True)
    shape = TB.ShapeConfig("x", 40, 2, kind)
    got = {}
    for dev in ("meta", "cpu"):
        step, args, _ = TD.build(cfg, shape, device=dev)
        got[dev] = TC.step_cost(step, *args)
    for key in ("dot_flops", "flops_by_op", "bytes", "gather_bytes",
                "scatter_bytes"):
        assert got["meta"][key] == got["cpu"][key], key
