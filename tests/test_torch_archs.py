"""The dense family's other archs through the port against the JAX package:
prosparse-llama2-13b, qwen3-8b (qk-norm), qwen1.5-32b (QKV bias, int8 KV
in its full config), granite-34b (MQA, ungated MLP, tied embeddings) and
gemma2-2b (local/global sliding windows, attention and final softcaps,
post-block norms, the embedding scale, head dim != d_model / n_heads), at
their ``reduced_config`` with the reference's weights carried over by
``repro_torch.bridge``.  The reference initialises norm scales and QKV
biases at zero; here they get seeded random values on both sides, so the
qk-norm, the biases and the post-block norms do something.

Every model path runs teacher forced (tokens are fed, so both sides see
the same inputs): ``prefill`` and ``decode_step`` on the dense cache, the
paged decode on both routes, ``prefill_chunk``; each with strategy pallas
and with sparsity off (then the MLP runs the arch's own silu or gelu).
gemma2's reduced window is 8 and every sequence here runs past it.

Tolerances.  With a float32 KV cache the two sides differ in float32
summation order only: logits within 1e-4, as ``tests/test_torch_lm.py``
holds them (seen: below 1e-5).  The int8 KV cache rounds q and p to
bfloat16 before their products, where a 1e-7 difference can move a value
by one bf16 ulp: logits within 5e-3, as there.  Stats come from integer
counts and must be equal; greedy tokens of a server must be equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PagedKVConfig as JPagedKVConfig
from repro.configs.registry import reduced_config as j_reduced
from repro.models import lm as jlm
from repro.runtime import server as jserver
from repro_torch import bridge
from repro_torch.configs.base import PagedKVConfig
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.core.sparse_mlp import MLP_STAT_KEYS
from repro_torch.kernels import ops
from repro_torch.models import lm as tlm
from repro_torch.runtime.server import Request, Server, ServeConfig

ARCHS = ("prosparse-llama2-13b", "qwen3-8b", "qwen1.5-32b", "granite-34b",
         "gemma2-2b")
INT8_KV = ("prosparse-llama2-13b", "qwen1.5-32b")   # int8 KV at full size
B, PLEN, STEPS, MAX_LEN = 2, 10, 4, 16
BS, NBPS = 4, 4                                    # paged: block, blocks/slot
TOL = {"float32": 1e-4, "int8": 5e-3}


def _cfgs(arch: str, mode: str = "pallas", kv: str = "float32",
          kernel: bool = False, **sparse_kw):
    """(reference config, port config): ``mode`` "pallas" (sparse) or
    "dense" (sparsity off, the arch's own activation)."""
    out = []
    for reduced in (j_reduced, t_reduced):
        cfg = reduced(arch)
        out.append(cfg.replace(
            kv_cache_dtype=kv, paged_attn_kernel=kernel,
            sparse=dataclasses.replace(cfg.sparse, strategy="pallas",
                                       enabled=mode == "pallas",
                                       **sparse_kw)))
    return out


@functools.lru_cache(maxsize=None)
def _ref_tree(arch: str) -> dict:
    """The reference's weights (numpy leaves) with norm scales and QKV
    biases drawn from a seeded generator instead of zeros."""
    jcfg, _ = _cfgs(arch)
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)

    def perturb(node):
        for k, v in node.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("scale", "bq", "bk", "bv"):
                node[k] = (rng.standard_normal(v.shape) * 0.3).astype(v.dtype)
    perturb(tree)
    return tree


def _params(arch: str, jcfg, tcfg, sparse: bool):
    tree = _ref_tree(arch)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = bridge.params_from_numpy(tree, tcfg, device="cpu")
    if sparse:
        jp, tp = jlm.prepare_sparse(jp), tlm.prepare_sparse(tp)
    return jp, tp


def _alphas(cfg) -> np.ndarray:
    return (cfg.sparse.alpha_schedule().alphas(cfg.n_layers)[:, None]
            + np.asarray([0.25, -0.25], np.float32)[None, :])


def _same_stats(tst, jst, msg):
    assert set(tst) == set(MLP_STAT_KEYS)
    for k in MLP_STAT_KEYS:
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]),
                                      err_msg=f"{msg} {k}")


def _cases():
    out = [(a, m, "float32") for a in ARCHS for m in ("pallas", "dense")]
    return out + [(a, "pallas", "int8") for a in INT8_KV]


@pytest.mark.parametrize("arch,mode,kv", _cases())
def test_prefill_and_decode_teacher_forced(arch, mode, kv):
    """A 10-token prefill, then 4 decode steps at per-slot alphas (lengths
    10-13: past gemma2's reduced window of 8)."""
    jcfg, tcfg = _cfgs(arch, mode, kv)
    jp, tp = _params(arch, jcfg, tcfg, mode == "pallas")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jcfg.vocab, size=(B, PLEN))
    forced = rng.integers(0, jcfg.vocab, size=(STEPS, B, 1))
    alphas = _alphas(jcfg)
    jstep = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg,
                                      collect_stats=True))
    jl, jc = jlm.prefill(jp, jcfg, jnp.asarray(prompt), MAX_LEN)
    with torch.inference_mode():
        tl, tc = tlm.prefill(tp, tcfg, torch.from_numpy(prompt), MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=TOL["float32"], err_msg="prefill")
    for t in range(STEPS):
        lens = np.full(B, PLEN + t, np.int32)
        jl, jc, jst = jstep(jp, token=jnp.asarray(forced[t]), caches=jc,
                            cache_len=jnp.asarray(lens),
                            alphas=jnp.asarray(alphas))
        with torch.inference_mode():
            tl, tc, tst = tlm.decode_step(
                tp, tcfg, torch.from_numpy(forced[t]), tc,
                torch.from_numpy(lens), alphas=alphas, collect_stats=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL[kv], err_msg=f"step {t}")
        _same_stats(tst, jst, f"step {t}")
        if jcfg.final_softcap:
            assert float(tl.abs().max()) < jcfg.final_softcap


def _fragmented(rng, b, nbps):
    """A shuffled table over a pool with 2 reserved blocks and 3 spare;
    slots 0 and 1 share their first block (read only: both lengths are
    past it)."""
    n = 2 + b * nbps + 3
    table = (rng.permutation(n - 2)[: b * nbps] + 2).reshape(b, nbps)
    table[1, 0] = table[0, 0]
    return n, table.astype(np.int32)


def _random_pool(rng, jcfg, n_blocks):
    tree = jax.tree.map(np.asarray, jlm.init_kv_pool(jcfg, n_blocks, BS))
    out = {}
    for name, a in tree["blocks"].items():
        if a.dtype == np.int8:
            out[name] = rng.integers(-127, 128, a.shape).astype(np.int8)
        elif name.endswith("scale"):
            out[name] = np.asarray(jnp.asarray(
                rng.uniform(0.005, 0.05, a.shape), a.dtype))
        else:
            out[name] = np.asarray(jnp.asarray(
                rng.standard_normal(a.shape), a.dtype))
    return {"blocks": out}


def _paged_cases():
    out = [(a, k, "float32") for a in ARCHS for k in (True, False)]
    return out + [(a, True, "int8") for a in INT8_KV]


@pytest.mark.parametrize("arch,kernel,kv", _paged_cases())
def test_paged_decode_teacher_forced(arch, kernel, kv):
    """4 decode steps from a fragmented pool of stale random content at
    lengths 7 and 9 to 10 and 12 (gemma2's window of 8 binds from the
    second step), the kernel route (the reference's Pallas kernel in
    interpret mode against the port's plain version, each folding
    hd^-0.5 / softcap into one constant) or the gather route.  An int8
    pool takes the gather route on both sides."""
    jcfg, tcfg = _cfgs(arch, "pallas", kv, kernel)
    jp, tp = _params(arch, jcfg, tcfg, True)
    rng = np.random.default_rng(4)
    n_blocks, table = _fragmented(rng, B, NBPS)
    tree = _random_pool(rng, jcfg, n_blocks)
    jpool = jax.tree.map(jnp.asarray, tree)
    tpool = bridge.pool_from_numpy(tree, tcfg, device="cpu")
    lens0 = np.asarray([7, 9], np.int32)
    forced = rng.integers(0, jcfg.vocab, size=(STEPS, B, 1))
    alphas = _alphas(jcfg)
    jstep = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg,
                                      collect_stats=True))
    for t in range(STEPS):
        lens = lens0 + t
        jl, jpool, jst = jstep(jp, token=jnp.asarray(forced[t]),
                               caches=jpool, cache_len=jnp.asarray(lens),
                               alphas=jnp.asarray(alphas),
                               block_table=jnp.asarray(table))
        with torch.inference_mode():
            tl, tpool, tst = tlm.decode_step(
                tp, tcfg, torch.from_numpy(forced[t]), tpool,
                torch.from_numpy(lens), alphas=alphas, collect_stats=True,
                block_table=torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL[kv], err_msg=f"step {t}")
        _same_stats(tst, jst, f"step {t}")


CHUNK = 8
VALID = np.asarray([20, 13], np.int32)      # 3 chunks; the last is padded


@pytest.mark.parametrize("mode", ["pallas", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_teacher_forced(arch, mode):
    """A 3-chunk prompt (chunks of 8, gemma2's window of 8 binding from
    the second) through ``prefill_chunk`` with sparse prefill: each chunk's
    logits within 1e-4 and stats equal, the float32 KV cache within
    1e-5."""
    jcfg, tcfg = _cfgs(arch, mode, sparse_prefill=True)
    jp, tp = _params(arch, jcfg, tcfg, mode == "pallas")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab, size=(B, 3 * CHUNK))
    alphas = _alphas(jcfg)
    jc = jlm.init_caches(jcfg, B, 32)
    tc = tlm.init_caches(tcfg, B, 32, device="cpu")
    jchunk = jax.jit(functools.partial(jlm.prefill_chunk, cfg=jcfg,
                                       collect_stats=True))
    for off in range(0, 3 * CHUNK, CHUNK):
        piece = tokens[:, off:off + CHUNK]
        jl, jc, jst = jchunk(jp, tokens=jnp.asarray(piece), caches=jc,
                             offset=jnp.int32(off), valid=jnp.asarray(VALID),
                             alphas=jnp.asarray(alphas))
        with torch.inference_mode():
            tl, tc, tst = tlm.prefill_chunk(
                tp, tcfg, torch.from_numpy(piece), tc, off,
                torch.from_numpy(VALID), alphas=alphas, collect_stats=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL["float32"],
                                   err_msg=f"chunk at {off}")
        _same_stats(tst, jst, f"chunk at {off}")
    for i in range(tcfg.n_layers):
        for name, buf in tc["blocks"][i].items():
            np.testing.assert_allclose(
                buf.numpy(), np.asarray(jc["blocks"][name][i]), rtol=0,
                atol=1e-5, err_msg=f"layer {i} {name}")


def _serve_pair(arch, paged: bool):
    jcfg, tcfg = _cfgs(arch, "pallas", kernel=paged, sparse_prefill=True)
    jp, tp = _params(arch, jcfg, tcfg, False)
    kw = dict(batch=2, max_len=32, prefill_chunk=CHUNK, prefill_interleave=2)
    jkw, tkw = dict(kw), dict(kw)
    if paged:
        jkw["paged_kv"] = JPagedKVConfig(block_size=BS)
        tkw["paged_kv"] = PagedKVConfig(block_size=BS)
    return (jserver.Server(jlm, jcfg, jserver.ServeConfig(**jkw), jp),
            Server(tlm, tcfg, ServeConfig(**tkw), tp, device="cpu"))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_match_reference(arch, paged):
    """Both servers on one queue of 4 mixed-tier requests (prompts of 5 to
    14 tokens, 6 new tokens each: gemma2's window binds), chunked sparse
    prefill, strategy pallas, dense cache or paged pool (kernel route):
    every request's tokens equal, and the same prefill chunks run."""
    jsrv, tsrv = _serve_pair(arch, paged)
    rng = np.random.default_rng(3)
    plens, tiers = (5, 14, 9, 12), ("latency", "balanced", "quality")
    prompts = [rng.integers(0, 512, size=p) for p in plens]
    done = []
    for srv, R in ((jsrv, jserver.Request), (tsrv, Request)):
        done.append(sorted(srv.serve([
            R(uid=i, prompt=p, max_new=6, sla=tiers[i % 3])
            for i, p in enumerate(prompts)]), key=lambda r: r.uid))
    for jr, tr in zip(*done):
        assert tr.outcome == jr.outcome == "completed"
        np.testing.assert_array_equal(tr.out, jr.out, err_msg=f"uid {tr.uid}")
    assert tsrv.prefill_chunks_run == jsrv.prefill_chunks_run
    if paged:
        assert tsrv.paged_stats() == jsrv.paged_stats()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_arch(arch):
    from repro_torch.launch import serve as serve_cli
    ops.reset_launch_counts()
    rep = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--requests", "2", "--batch", "2", "--max-new",
                          "4"])
    assert rep["completed"] == 2 and rep["tokens"] == 8
    assert sum(ops.launch_counts().values()) == 0       # plain on the CPU


def test_gemma2_layers_alternate_local_and_global():
    """Layer i takes windows[i % 2]: even layers local (the window), odd
    ones global; the reference's pattern."""
    _, tcfg = _cfgs("gemma2-2b")
    assert tlm._windows(tcfg) == jlm._windows(j_reduced("gemma2-2b")) == \
        (8, 0)
    assert tlm._layer_windows(tcfg) == [8, 0, 8, 0]
    with pytest.raises(ValueError, match="local_global_period"):
        tlm.init_lm(tcfg.replace(n_layers=3), device="cpu")
    assert tlm._layer_windows(t_reduced("qwen3-8b")) == [0, 0]
