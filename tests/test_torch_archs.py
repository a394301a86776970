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

from repro.configs.base import ControllerConfig as JControllerConfig
from repro.configs.base import PagedKVConfig as JPagedKVConfig
from repro.configs.registry import reduced_config as j_reduced
from repro.models import lm as jlm
from repro.runtime import server as jserver
from repro_torch import bridge
from repro_torch.configs.base import ControllerConfig, PagedKVConfig
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.core.sparse_mlp import MLP_STAT_KEYS, SHARD_RIDER_KEYS
from repro_torch.kernels import ops
from repro_torch.models import lm as tlm
from repro_torch.runtime.server import Request, Server, ServeConfig

ARCHS = ("prosparse-llama2-13b", "qwen3-8b", "qwen1.5-32b", "granite-34b",
         "gemma2-2b")
INT8_KV = ("prosparse-llama2-13b", "qwen1.5-32b")   # int8 KV at full size
B, PLEN, STEPS, MAX_LEN = 2, 10, 4, 16
BS, NBPS = 4, 4                                    # paged: block, blocks/slot
TOL = {"float32": 1e-4, "int8": 5e-3}
QG = 16                                            # int8 quant group width


def _cfgs(arch: str, mode: str = "pallas", kv: str = "float32",
          kernel: bool = False, d_ff: int = 0, **sparse_kw):
    """(reference config, port config): ``mode`` a strategy (sparse) or
    "dense" (sparsity off, the arch's own activation); ``d_ff`` replaces
    the reduced width."""
    out = []
    for reduced in (j_reduced, t_reduced):
        cfg = reduced(arch)
        out.append(cfg.replace(
            kv_cache_dtype=kv, paged_attn_kernel=kernel,
            d_ff=d_ff or cfg.d_ff,
            sparse=dataclasses.replace(
                cfg.sparse, strategy="pallas" if mode == "dense" else mode,
                enabled=mode != "dense", **sparse_kw)))
    return out


@functools.lru_cache(maxsize=None)
def _ref_tree(arch: str, d_ff: int = 0) -> dict:
    """The reference's weights (numpy leaves) with norm scales and QKV
    biases drawn from a seeded generator instead of zeros."""
    jcfg, _ = _cfgs(arch, d_ff=d_ff)
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


def _params(arch: str, jcfg, tcfg, sparse: bool, d_ff: int = 0):
    """Both sides' params; ``sparse``: through each side's
    ``prepare_sparse`` with its config (int8 weights quantized)."""
    tree = _ref_tree(arch, d_ff)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = bridge.params_from_numpy(tree, tcfg, device="cpu")
    if sparse:
        jp = jlm.prepare_sparse(jp, jcfg.sparse)
        tp = tlm.prepare_sparse(tp, tcfg.sparse)
    return jp, tp


def _alphas(cfg) -> np.ndarray:
    return (cfg.sparse.alpha_schedule().alphas(cfg.n_layers)[:, None]
            + np.asarray([0.25, -0.25], np.float32)[None, :])


def _same_stats(tst, jst, msg, riders: bool = False):
    """Every stat equal; ``riders``: the per-shard riders too."""
    keys = MLP_STAT_KEYS + (SHARD_RIDER_KEYS if riders else ())
    assert set(tst) == set(jst) == set(keys), (set(tst), set(jst))
    for k in keys:
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]),
                                      err_msg=f"{msg} {k}")


def _cases():
    out = [(a, m, "float32") for a in ARCHS for m in ("pallas", "dense")]
    return out + [(a, "pallas", "int8") for a in INT8_KV]


def _prefill_decode(jcfg, tcfg, jp, tp, tol: float, seed: int = 0,
                    stats: bool = True, riders: bool = False) -> list:
    """A 10-token prefill, then 4 teacher-forced decode steps at per-slot
    alphas: the prefill's logits within 1e-4, each step's within ``tol``
    and (``stats``) its MLP stats equal (``riders``: the per-shard riders
    too).  Returns the port's per-step stats."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, jcfg.vocab, size=(B, PLEN))
    forced = rng.integers(0, jcfg.vocab, size=(STEPS, B, 1))
    alphas = _alphas(jcfg)
    jstep = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg,
                                      collect_stats=stats))
    jl, jc = jlm.prefill(jp, jcfg, jnp.asarray(prompt), MAX_LEN)
    with torch.inference_mode():
        tl, tc = tlm.prefill(tp, tcfg, torch.from_numpy(prompt), MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=TOL["float32"], err_msg="prefill")
    out = []
    for t in range(STEPS):
        lens = np.full(B, PLEN + t, np.int32)
        jout = jstep(jp, token=jnp.asarray(forced[t]), caches=jc,
                     cache_len=jnp.asarray(lens), alphas=jnp.asarray(alphas))
        with torch.inference_mode():
            tout = tlm.decode_step(
                tp, tcfg, torch.from_numpy(forced[t]), tc,
                torch.from_numpy(lens), alphas=alphas, collect_stats=stats)
        (jl, jc), (tl, tc) = jout[:2], tout[:2]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=tol, err_msg=f"step {t}")
        if stats:
            _same_stats(tout[2], jout[2], f"step {t}", riders)
            out.append(tout[2])
        if jcfg.final_softcap:
            assert float(tl.abs().max()) < jcfg.final_softcap
    return out


@pytest.mark.parametrize("arch,mode,kv", _cases())
def test_prefill_and_decode_teacher_forced(arch, mode, kv):
    """A 10-token prefill, then 4 decode steps at per-slot alphas (lengths
    10-13: past gemma2's reduced window of 8)."""
    jcfg, tcfg = _cfgs(arch, mode, kv)
    jp, tp = _params(arch, jcfg, tcfg, mode == "pallas")
    _prefill_decode(jcfg, tcfg, jp, tp, TOL[kv])


def _probe_cases():
    return [(a, s, w) for a in ARCHS for s, w in (
        ("masked", ""), ("gather", ""), ("pallas", "int8"),
        ("gather", "int8"))]


@pytest.mark.parametrize("arch,strategy,weights", _probe_cases())
def test_strategies_and_int8_teacher_forced(arch, strategy, weights):
    """Strategies masked and gather, and int8 MLP weights (quant groups of
    16) under pallas and gather, at d_ff=512 where the capacity clamp
    binds: a 10-token prefill and 4 decode steps, logits within 1e-4 and
    every stat equal."""
    jcfg, tcfg = _cfgs(arch, strategy, d_ff=512, weight_dtype=weights,
                       quant_group_size=QG)
    jp, tp = _params(arch, jcfg, tcfg, True, 512)
    if weights:
        assert tp["blocks"][0]["mlp"]["wg_q"].dtype == torch.int8
    _prefill_decode(jcfg, tcfg, jp, tp, TOL["float32"], seed=7)


def _fragmented(rng, b, nbps):
    """A shuffled table over a pool with 2 reserved blocks and 3 spare;
    slots 0 and 1 share their first block (read only: both lengths are
    past it)."""
    n = 2 + b * nbps + 3
    table = (rng.permutation(n - 2)[: b * nbps] + 2).reshape(b, nbps)
    table[1, 0] = table[0, 0]
    return n, table.astype(np.int32)


def _random_pool(rng, jcfg, n_blocks):
    """The reference's pool tree (``blocks``, and ``first`` for a moe
    config's first layers) filled with stale random content."""
    tree = jax.tree.map(np.asarray, jlm.init_kv_pool(jcfg, n_blocks, BS))
    out = {}
    for part, leaves in tree.items():
        out[part] = {}
        for name, a in leaves.items():
            if a.dtype == np.int8:
                v = rng.integers(-127, 128, a.shape).astype(np.int8)
            elif name.endswith("scale"):
                v = np.asarray(jnp.asarray(
                    rng.uniform(0.005, 0.05, a.shape), a.dtype))
            else:
                v = np.asarray(jnp.asarray(rng.standard_normal(a.shape),
                                           a.dtype))
            out[part][name] = v
    return out


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


def _close(a, b, path=""):
    """Reports equal: ints, bools and strings exactly, floats to 1e-5."""
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(b, float):
        assert abs(a - b) <= 1e-5, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _requests(seed: int, n: int, vocab: int, cls, prefix: int = 0):
    """``n`` mixed-tier requests of 5-14 prompt tokens after a shared
    ``prefix``, 4-7 new tokens each."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=prefix)
    slas = ("latency", "balanced", "quality")
    return [cls(uid=i, prompt=np.concatenate([shared, rng.integers(
                0, vocab, size=int(rng.integers(5, 15)))]),
                max_new=int(rng.integers(4, 8)), sla=slas[i % 3])
            for i in range(n)]


def _serve_ctrl(arch, strategy, *, paged=False, buckets=(), d_ff=0,
                weights="", prefix=0, n=5, **sparse_kw):
    """The reference's and the port's servers with the per-tier controller
    (masked audits every 4th step where the strategy takes them), chunked
    sparse prefill in chunks of 8, batch 2, on one queue of ``n``
    mixed-tier requests: tokens, the controller's report within 1e-5, the
    bucket sequence and, on a pool (kernel route), ``paged_stats()``
    equal.  Returns both servers."""
    jcfg, tcfg = _cfgs(arch, strategy, kernel=paged, d_ff=d_ff,
                       capacity_buckets=buckets, sparse_prefill=True,
                       weight_dtype=weights, quant_group_size=QG,
                       **sparse_kw)
    jp, tp = _params(arch, jcfg, tcfg, False, d_ff)
    # fn_budget 0.5: the false-negative term (reduced dims mispredict
    # often) must not hold alpha up, or the union never leaves the top rung
    ccfg = dict(enabled=True, target_density=0.2, gain=1.0, ema=0.5,
                audit_period=4, fn_budget=0.5, per_tier=True,
                prefill_weight=0.5)
    kw = dict(batch=2, max_len=32, prefill_chunk=CHUNK, prefill_interleave=2)
    jkw, tkw = dict(kw), dict(kw)
    if paged:
        jkw["paged_kv"] = JPagedKVConfig(block_size=BS)
        tkw["paged_kv"] = PagedKVConfig(block_size=BS)
    jsrv = jserver.Server(jlm, jcfg, jserver.ServeConfig(
        controller=JControllerConfig(**ccfg), **jkw), jp)
    tsrv = Server(tlm, tcfg, ServeConfig(
        controller=ControllerConfig(**ccfg), **tkw), tp, device="cpu")
    j_buckets = []
    select = jsrv._select_bucket

    def recording_select():
        j_buckets.append(select())
        return j_buckets[-1]
    jsrv._select_bucket = recording_select
    jdone = jsrv.serve(_requests(3, n, jcfg.vocab, jserver.Request, prefix))
    tdone = tsrv.serve(_requests(3, n, tcfg.vocab, Request, prefix))
    for jr, tr in zip(sorted(jdone, key=lambda r: r.uid),
                      sorted(tdone, key=lambda r: r.uid)):
        assert tr.outcome == jr.outcome == "completed"
        np.testing.assert_array_equal(tr.out, jr.out, err_msg=f"uid {tr.uid}")
    assert tsrv.prefill_chunks_run == jsrv.prefill_chunks_run
    _close(tsrv.controller.report(), jsrv.controller.report())
    assert list(tsrv.bucket_history) == j_buckets
    if paged:
        assert tsrv.paged_stats() == jsrv.paged_stats()
        tsrv.kv_pool.check_invariants()
    return jsrv, tsrv


SERVE_PROBES = {
    # strategy, paged, ladder, int8 weights, shared prefix
    "gather-ladder": ("gather", False, (0.25, 0.5, 1.0), "", 0),
    "pallas-paged-prefix": ("pallas", True, (), "", 8),
    "masked-dense": ("masked", False, (), "", 0),
    "gather-int8": ("gather", False, (0.25, 0.5, 1.0), "int8", 0),
}


@pytest.mark.parametrize("probe", sorted(SERVE_PROBES))
@pytest.mark.parametrize("arch", ARCHS)
def test_controller_serve_matches_reference(arch, probe):
    """The per-tier controller-driven server at d_ff=512 (ladder rungs of
    16, 32 and 64 groups): gather over the 3-rung ladder (float and int8
    weights), pallas on a paged pool with an 8-token prefix shared by
    every request, masked on dense caches."""
    strategy, paged, buckets, weights, prefix = SERVE_PROBES[probe]
    _, tsrv = _serve_ctrl(arch, strategy, paged=paged, buckets=buckets,
                          d_ff=512, weights=weights, prefix=prefix)
    if buckets:
        assert set(tsrv.bucket_history) <= {16, 32, 64}


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
