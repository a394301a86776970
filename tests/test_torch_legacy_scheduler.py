"""The legacy chunked scheduler (``ServeConfig(slot_refill=False)``) in
the port against the reference's (``repro/runtime/server.py``:
``serve`` at :1170-1205, ``_serve_chunked`` at :1207).

Both servers run reduced prosparse-llama2-7b on the reference's weights:

- the same queue gives every request the same tokens (strategy pallas,
  mixed tiers; monolithic prompt widths and ``prefill_chunk``'s ladder;
  with the adaptive-alpha controller on the 'balanced' tier), and each
  request's tokens are its chunk's ``generate`` (prefill then decode,
  teacher-forced against the reference's logits: every emitted token is
  the reference model's argmax of the prefix it was fed, up to logits
  within 1e-4 of the top);
- the chunks' prefill widths are the longest prompt, padded up to a
  multiple of ``prefill_chunk`` when it is set;
- a chunk whose padded prompt plus its largest ``max_new`` exceeds
  ``max_len`` raises the reference's error before any prefill runs;
- the SLA-tier warning comes once a serve, only with non-uniform tiers;
  the paged pool refuses the scheduler, and ``prefill_chunk`` on a family
  without chunked prefill does not warn without slot refill, as in the
  reference;
- the serve CLI's ``--slot-refill/--no-slot-refill`` selects the
  scheduler and reports ``scheduler`` and ``sla_applied``.
"""
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ControllerConfig as JControllerConfig
from repro.configs.base import PagedKVConfig as JPagedKVConfig
from repro.configs.registry import reduced_config as j_reduced
from repro.models import lm as jlm
from repro.runtime import server as jserver
from repro_torch import bridge
from repro_torch.configs.base import ControllerConfig, PagedKVConfig
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lm as tlm
from repro_torch.runtime.server import Request, Server, ServeConfig

ARCH = "prosparse-llama2-7b"
TIER_WARNING = "chunked scheduler ignores per-request SLA tiers"
TIERS = ("latency", "balanced", "quality")


def _weights(arch: str = ARCH):
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    return (jcfg, jax.tree.map(jnp.asarray, tree),
            tcfg, bridge.params_from_numpy(tree, tcfg, device="cpu"))


def _recording(mod, widths: list):
    """``mod`` with its ``prefill`` recording each call's prompt shape."""
    def prefill(params, cfg, tokens, *a, **k):
        widths.append(tuple(tokens.shape))
        return mod.prefill(params, cfg, tokens, *a, **k)
    return types.SimpleNamespace(**{**vars(mod), "prefill": prefill})


def _servers(ctl: bool = False, **scfg):
    jcfg, jp, tcfg, tp = _weights()
    jw, tw = [], []
    kw = dict(batch=2, max_len=32, slot_refill=False, **scfg)
    jsrv = jserver.Server(_recording(jlm, jw), jcfg, jserver.ServeConfig(
        controller=JControllerConfig(enabled=ctl), **kw), jp)
    tsrv = Server(_recording(tlm, tw), tcfg, ServeConfig(
        controller=ControllerConfig(enabled=ctl), **kw), tp, device="cpu")
    return (jsrv, jw), (tsrv, tw)


def _queue(R, plens, max_news, tiers=TIERS, seed=3):
    rng = np.random.default_rng(seed)
    return [R(uid=i, prompt=rng.integers(0, 512, size=p), max_new=m,
              sla=tiers[i % len(tiers)])
            for i, (p, m) in enumerate(zip(plens, max_news))]


def _serve(srv, R, *queue_args, **queue_kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        done = srv.serve(_queue(R, *queue_args, **queue_kw))
    tier = [w for w in caught if TIER_WARNING in str(w.message)]
    return sorted(done, key=lambda r: r.uid), len(tier)


@pytest.mark.parametrize("pc,ctl", [(0, False), (8, False), (0, True)])
def test_chunked_serve_matches_reference(pc, ctl):
    (jsrv, jw), (tsrv, tw) = _servers(ctl=ctl, prefill_chunk=pc)
    plens, news = (5, 13, 9, 3, 7), (4, 6, 3, 5, 2)
    jdone, jwarn = _serve(jsrv, jserver.Request, plens, news)
    tdone, twarn = _serve(tsrv, Request, plens, news)
    assert jwarn == twarn == 1
    for jr, tr in zip(jdone, tdone):
        assert tr.outcome == jr.outcome == "completed"
        np.testing.assert_array_equal(tr.out, jr.out, err_msg=f"uid {tr.uid}")
        assert tr.out.shape == (tr.max_new,)
        assert tr.t_end >= tr.t_start > 0 and tr.latency_s > 0
        assert tr.ttft_s == 0.0
    # three chunks (2 + 2 + 1 requests), one prefill each at the chunk's
    # longest prompt (padded up to the ladder with prefill_chunk)
    want = [(2, 13), (2, 9), (2, 7)] if not pc else [(2, 16), (2, 16),
                                                     (2, 8)]
    assert tw == want
    assert jw[:len(set(jw))] == list(dict.fromkeys(want))  # traces
    # a chunk's requests share its time stamps
    assert tdone[0].t_end == tdone[1].t_end != tdone[2].t_end


def test_tokens_are_the_reference_models_argmax():
    """Teacher-forced: each chunk's prompt (right-aligned, token 0 in
    front) plus the tokens the port emitted, fed to the reference's
    ``prefill`` and ``decode_step``; every emitted token scores within
    1e-4 of the reference's top logit at its step."""
    jcfg, jp, tcfg, tp = _weights()
    srv = Server(tlm, tcfg, ServeConfig(batch=2, max_len=32,
                                        slot_refill=False), tp, device="cpu")
    done, _ = _serve(srv, Request, (6, 11), (5, 5), tiers=("balanced",))
    prompts = np.zeros((2, 11), np.int32)
    for i, r in enumerate(done):
        prompts[i, 11 - len(r.prompt):] = r.prompt
    out = np.stack([r.out for r in done])
    logits, caches = jlm.prefill(jp, jcfg, jnp.asarray(prompts), 32)
    for t in range(out.shape[1]):
        lg = np.asarray(logits)
        picked = lg[np.arange(2), out[:, t]]
        assert (picked >= lg.max(-1) - 1e-4).all(), f"step {t}"
        logits, caches = jlm.decode_step(
            jp, jcfg, jnp.asarray(out[:, t:t + 1]), caches,
            jnp.int32(11 + t))


def test_overflow_is_refused_up_front():
    (jsrv, jw), (tsrv, tw) = _servers(prefill_chunk=8)
    errors = []
    for srv, R in ((jsrv, jserver.Request), (tsrv, Request)):
        # chunk 1: prompts 9 and 4 pad to 16, + max_new 17 = 33 > 32 (each
        # request alone fits: 9 + 17 and 4 + 17)
        with pytest.raises(ValueError, match="padded prompt") as err:
            srv.serve(_queue(R, (3, 5, 9, 4), (4, 4, 17, 2)))
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "chunk 1" in errors[1] and tw == jw == []


def test_uniform_tiers_do_not_warn():
    (jsrv, _), (tsrv, _) = _servers()
    _, jwarn = _serve(jsrv, jserver.Request, (4, 5, 6), (3, 3, 3),
                      tiers=("balanced",))
    _, twarn = _serve(tsrv, Request, (4, 5, 6), (3, 3, 3),
                      tiers=("balanced",))
    assert jwarn == twarn == 0


def test_refusals_and_warnings_follow_the_reference():
    jcfg, jp, tcfg, tp = _weights()
    with pytest.raises(ValueError, match="slot-refill"):
        jserver.Server(jlm, jcfg, jserver.ServeConfig(
            batch=2, max_len=32, slot_refill=False,
            paged_kv=JPagedKVConfig(block_size=8)), jp)
    with pytest.raises(ValueError, match="slot-refill"):
        Server(tlm, tcfg, ServeConfig(batch=2, max_len=32, slot_refill=False,
                                      paged_kv=PagedKVConfig(block_size=8)),
               tp, device="cpu")
    # a family without chunked prefill warns only under slot refill
    hcfg = t_reduced("zamba2-1.2b")
    hp = tlm.init_lm(hcfg, 0, device="cpu")
    for refill, n in ((True, 1), (False, 0)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            Server(tlm, hcfg, ServeConfig(batch=2, max_len=32,
                                          prefill_chunk=8,
                                          slot_refill=refill),
                   hp, device="cpu")
        assert sum("no chunked prefill" in str(w.message)
                   for w in caught) == n, refill


@pytest.mark.parametrize("flag,scheduler", [([], "slot_refill"),
                                            (["--no-slot-refill"],
                                             "chunked")])
def test_cli_selects_the_scheduler(flag, scheduler):
    rep = serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--requests", "3", "--batch", "2", "--max-new",
                          "3", "--max-len", "32", "--prompt-len", "6",
                          "--sla-mix", "latency:1,balanced:1"] + flag)
    assert rep["scheduler"] == scheduler
    assert rep["sla_applied"] is (scheduler == "slot_refill")
    assert rep["completed"] == 3 and rep["tokens"] == 9
