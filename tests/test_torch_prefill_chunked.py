"""Chunked sparse prefill in the port against the reference.

- the chunk kernels' plain versions against the reference's Pallas kernels
  in interpret mode: margins, counts and telemetry exact, y within
  rtol=atol=1e-5 (float32 sums of the same products in another order);
- reduced prosparse-llama2-7b with ``sparse_prefill``, ``sparse_max_batch=4``
  and chunks of 8 rows (so the chunk kernels' branch runs): the port's
  ``prefill_chunk`` chain against ``repro.models.lm.prefill_chunk``, teacher
  forced over a 3-chunk prompt whose last chunk is padded, with float and
  int8 MLP weights.  Logits within 1e-5, stats within 1e-6, the float32 KV
  cache within 1e-5 and the int8 one within 5e-3 (its bf16 scales turn a
  1e-7 input difference into one bf16 ulp, as tests/test_torch_lm.py
  holds it);
- the chunked slot-refill server: it completes, a pending slot is dead in
  the decode union, and ServeConfig validation raises as the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as j_reduced
from repro.core import predictor as JP
from repro.core import selection as JS
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.core.sparse_mlp import DEAD_SLOT_ALPHA, MLP_STAT_KEYS
from repro_torch.kernels import ops as tops
from repro_torch.models import lm as tlm
from repro_torch.runtime.server import Request, Server, ServeConfig

ARCH = "prosparse-llama2-7b"
G = 8
TOL = dict(rtol=1e-5, atol=1e-5)
CHUNK, MAX_LEN = 8, 32
VALID = np.asarray([20, 17], np.int32)      # 3 chunks; the last is padded


def _t(a):
    return torch.from_numpy(np.array(a))


def _kernel_inputs(seed: int, s: int, d: int = 128, k: int = 512):
    rng = np.random.default_rng(seed)
    w = {n: (rng.standard_normal((k, d)) * d ** -0.5).astype(np.float32)
         for n in ("wg_t", "wu_t", "wd_t")}
    x = rng.standard_normal((s, d)).astype(np.float32)
    a = np.full(s, 1.0, np.float32)
    a[::5] = DEAD_SLOT_ALPHA                # pad rows of a chunk
    a[1::7] = 1.03
    return w, x, a


@pytest.mark.parametrize("s", [17, 24])
def test_predict_chunk_group_margins_exact(s):
    w, x, a = _kernel_inputs(0, s)
    pw = JP.pack_signs(jnp.asarray(w["wg_t"]))
    gm_r, cnt_r = jops.predict_chunk_group_margins(
        pw, jnp.asarray(x), 128, jnp.asarray(a), group_size=G,
        interpret=True)
    gm_p, cnt_p = tops.predict_chunk_group_margins(_t(pw), _t(x), 128, _t(a),
                                                   group_size=G)
    np.testing.assert_array_equal(gm_p.numpy(), np.asarray(gm_r))
    np.testing.assert_array_equal(cnt_p.numpy(), np.asarray(cnt_r))
    # per row, the decode predictor's outputs
    gm_1, cnt_1 = tops.predict_group_margins(_t(pw), _t(x[:4]), 128,
                                             _t(a[:4]), group_size=G)
    np.testing.assert_array_equal(gm_1.numpy(), gm_p.numpy()[:4])
    np.testing.assert_array_equal(cnt_1.numpy(), cnt_p.numpy()[:4])


@pytest.mark.parametrize("variant", ["gated", "ungated", "short-count"])
def test_fused_sparse_mlp_chunk_and_telemetry(variant):
    s = 20
    w, x, a = _kernel_inputs(1, s)
    if variant == "ungated":
        del w["wu_t"]
    pw = JP.pack_signs(jnp.asarray(w["wg_t"]))
    gm, _ = jops.predict_chunk_group_margins(pw, jnp.asarray(x), 128,
                                             jnp.asarray(a), group_size=G,
                                             interpret=True)
    sel, _ = JS.capacity_select_with_stats(JS.union_margin(gm), 16)
    count = sel.count // 2 if variant == "short-count" else sel.count
    names = ("wg_t", "wu_t", "wd_t")
    y_r, tel_r = jops.fused_sparse_mlp_chunk(
        jnp.asarray(x), *[jnp.asarray(w[n]) if n in w else None
                          for n in names],
        sel.indices, count, gm, group_size=G, collect_stats=True,
        interpret=True)
    y_p, tel_p = tops.fused_sparse_mlp_chunk(
        _t(x), *[_t(w[n]) if n in w else None for n in names],
        _t(sel.indices), _t(count), _t(gm), group_size=G,
        collect_stats=True)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_array_equal(tel_p.numpy(), np.asarray(tel_r))


def _cfgs(weight_dtype: str, kv: str = "float32"):
    out = []
    for reduced in (j_reduced, t_reduced):
        cfg = reduced(ARCH)
        out.append(cfg.replace(kv_cache_dtype=kv, sparse=dataclasses.replace(
            cfg.sparse, strategy="pallas", sparse_max_batch=4,
            sparse_prefill=True, weight_dtype=weight_dtype,
            quant_group_size=32)))
    return out


_JCHUNK: dict = {}


@pytest.mark.parametrize("weights,kv,kv_tol", [("", "float32", 1e-5),
                                               ("int8", "float32", 1e-5),
                                               ("int8", "int8", 5e-3)])
def test_prefill_chunk_teacher_forced(weights, kv, kv_tol):
    jcfg, tcfg = _cfgs(weights, kv)
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = tlm.prepare_sparse(bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"), tcfg.sparse)
    jparams = jlm.prepare_sparse(jparams, jcfg.sparse)
    b = len(VALID)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, size=(b, 3 * CHUNK))
    alphas = (jcfg.sparse.alpha_schedule().alphas(jcfg.n_layers)[:, None]
              + np.asarray([0.02, -0.02], np.float32)[None, :])
    key = (weights, kv)
    if key not in _JCHUNK:
        _JCHUNK[key] = jax.jit(functools.partial(
            jlm.prefill_chunk, cfg=jcfg, collect_stats=True))
    jc = jlm.init_caches(jcfg, b, MAX_LEN)
    tc = tlm.init_caches(tcfg, b, MAX_LEN, device="cpu")
    for off in range(0, 3 * CHUNK, CHUNK):
        chunk = tokens[:, off:off + CHUNK]
        jl, jc, jst = _JCHUNK[key](jparams, tokens=jnp.asarray(chunk),
                                   caches=jc, offset=jnp.int32(off),
                                   valid=jnp.asarray(VALID),
                                   alphas=jnp.asarray(alphas))
        with torch.inference_mode():
            tl, tc, tst = tlm.prefill_chunk(
                tparams, tcfg, _t(chunk), tc, off, _t(VALID), alphas=alphas,
                collect_stats=True)
        msg = f"chunk at {off}"
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-5, err_msg=msg)
        assert set(tst) == set(MLP_STAT_KEYS)
        for k in MLP_STAT_KEYS:
            assert tst[k].shape == (tcfg.n_layers, b)
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{msg} {k}")
    for i in range(tcfg.n_layers):
        for name, buf in tc["blocks"][i].items():
            np.testing.assert_allclose(
                buf.float().numpy(),
                np.asarray(jc["blocks"][name][i]).astype(np.float32),
                rtol=0, atol=kv_tol, err_msg=f"layer {i} {name}")
    # pad rows never entered a union: the realized density is that of the
    # real rows, and the pad positions of the cache stay zero
    assert not tc["blocks"][0]["k"][1, VALID[1]:3 * CHUNK].any()


def test_mlp_apply_prefill_runs_dense_past_prefill_max_tokens():
    from repro_torch.core import sparse_mlp as SM
    from repro_torch.layers.mlp import mlp_apply
    _, tcfg = _cfgs("")
    params = tlm.prepare_sparse(tlm.init_lm(tcfg, 0, device="cpu"),
                                tcfg.sparse)["blocks"][0]["mlp"]
    x = torch.randn((2, 6, tcfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    sp = dataclasses.replace(tcfg.sparse, capacity_override=4)  # 4 groups
    _, st = mlp_apply(params, x, sp, prefill=True, return_stats=True)
    assert float(st["realized_density"].max()) <= 4 * G / tcfg.d_ff
    over = dataclasses.replace(sp, prefill_max_tokens=11)
    y, st = mlp_apply(params, x, over, prefill=True, return_stats=True)
    torch.testing.assert_close(y, SM.dense_mlp(params, x, sp), rtol=0,
                               atol=0)
    assert bool((st["realized_density"] == 1.0).all())
    off = dataclasses.replace(sp, sparse_prefill=False)
    torch.testing.assert_close(mlp_apply(params, x, off, prefill=True),
                               SM.dense_mlp(params, x, sp), rtol=0, atol=0)


def _server(weights: str, **scfg):
    _, tcfg = _cfgs(weights)
    return tcfg, Server(tlm, tcfg, ServeConfig(batch=2, max_len=64, **scfg),
                        tlm.init_lm(tcfg, 0, device="cpu"), device="cpu")


def _requests(rng, plens, vocab, max_new=4):
    tiers = ("latency", "balanced", "quality")
    return [Request(uid=i, prompt=rng.integers(0, vocab, size=p),
                    max_new=max_new, sla=tiers[i % 3])
            for i, p in enumerate(plens)]


@pytest.mark.parametrize("weights", ["", "int8"])
def test_chunked_serve_completes(weights):
    cfg, srv = _server(weights, prefill_chunk=CHUNK, prefill_interleave=2)
    plens = [5, 21, 9, 17, 1]
    done = srv.serve(_requests(np.random.default_rng(1), plens, cfg.vocab))
    assert sorted(r.uid for r in done) == list(range(len(plens)))
    for r in done:
        assert r.outcome == "completed" and r.out.shape == (4,)
        assert ((r.out >= 0) & (r.out < cfg.vocab)).all()
        assert r.ttft_s > 0 and r.latency_s >= r.ttft_s
    assert srv.prefill_chunks_run == sum(-(-p // CHUNK) for p in plens)
    assert srv.prefill_chunks_skipped == 0


def test_chunked_prefill_first_token_matches_monolithic():
    """The chunk chain's last logits give the same first token as a
    monolithic prefill of the same prompt (dense MLP: the two differ only
    in float32 summation order)."""
    cfg, _ = _server("")
    cfg = cfg.replace(sparse=dataclasses.replace(cfg.sparse, enabled=False))
    params = tlm.init_lm(cfg, 3, device="cpu")
    prompt = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, size=(1, 13)))
    with torch.inference_mode():
        mono, mc = tlm.prefill(params, cfg, prompt, MAX_LEN)
        padded = torch.zeros((1, 16), dtype=prompt.dtype)
        padded[:, :13] = prompt
        caches = tlm.init_caches(cfg, 1, MAX_LEN, device="cpu")
        for off in (0, CHUNK):
            lg, caches = tlm.prefill_chunk(params, cfg,
                                           padded[:, off:off + CHUNK],
                                           caches, off, 13)
    torch.testing.assert_close(lg, mono, rtol=0, atol=1e-5)
    for got, want in zip(caches["blocks"], mc["blocks"]):
        torch.testing.assert_close(got["k"], want["k"], rtol=0, atol=1e-5)


def test_pending_slot_gets_dead_alpha_column():
    """A slot still streaming prefill chunks is dead in the decode union:
    its alpha column is DEAD_SLOT_ALPHA for every decode step before it is
    placed (the reference's TestMidPrefillDeadSlot)."""
    cfg, srv = _server("", prefill_chunk=CHUNK, prefill_interleave=1)
    seen = []
    orig = srv._slot_alpha_matrix

    def spy(tier_idx, active):
        mat = orig(tier_idx, active)
        seen.append((active.copy(), mat))
        return mat

    srv._slot_alpha_matrix = spy
    # slot 0: one chunk; slot 1: four chunks at interleave 1 -> slot 0
    # decodes while slot 1 is still mid-prefill
    srv.serve(_requests(np.random.default_rng(4), [6, 30], cfg.vocab,
                        max_new=8))
    partial = [(a, m) for a, m in seen if not a.all()]
    assert partial, "no decode step ever saw a mid-prefill slot"
    act, mat = partial[0]
    assert act[0] and not act[1]
    np.testing.assert_array_equal(
        mat[:, 1], np.full(cfg.n_layers, DEAD_SLOT_ALPHA, np.float32))
    assert not np.any(mat[:, 0] == DEAD_SLOT_ALPHA)


@pytest.mark.parametrize("scfg,match", [
    (dict(prefill_chunk=7), "prefill_chunk"),
    (dict(prefill_chunk=-8), "prefill_chunk"),
    (dict(prefill_chunk=8, prefill_interleave=0), "prefill_interleave")])
def test_prefill_chunk_validation(scfg, match):
    with pytest.raises(ValueError, match=match):
        _server("", **scfg)
