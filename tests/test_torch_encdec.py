"""The encdec family through the port against the JAX package:
seamless-m4t-medium at its ``reduced_config`` (2 encoder and 2 decoder
layers, 16 frames; LayerNorm, an ungated ReLU FFN), with the reference's
weights carried over by ``repro_torch.bridge``.  ``tests/test_torch_vlm.py``
holds llama-3.2-vision-90b with the harness of this file.

The reference starts LayerNorm at scale 1 and bias 0 and a vlm's gates at
0, where a cross block adds nothing (tanh(0) = 0) and a parity test would
pass with cross attention wrong.  Here every norm scale and bias, every
QKV bias and every gate gets a seeded random value on both sides, each
gate at least 0.3 from 0.  Frames and images come from a seeded numpy
generator.

Tolerances, as ``tests/test_torch_archs.py`` holds the dense archs:
``encode`` and the layernorm within 1e-5; logits within 1e-4 with a
float32 KV cache and 5e-3 with int8 KV (q and p rounded to bf16 there);
caches within 1e-5; the MLP stats, selections and a server's tokens,
controller report (floats to 1e-5) and bucket sequence exactly.  At
``reduced_config`` k=128 is 16 row groups, all selected; the cases at
``d_ff=512`` (64 groups, capacity 32) make the clamp bind and give the
bucket ladder its rungs (16/32/64 groups).

The reference's controller-driven ``Server`` passes ``block_table=None``
to a ``decode_step`` of these families that takes no such argument
(``repro/runtime/server.py:576``), a TypeError.  The JAX package is not
edited: its server is handed ``_RefShim``, the reference module with a
``decode_step`` that drops a None ``block_table`` and calls the
reference's own ``decode_step`` unchanged.
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
from repro.layers import norms as jnorms
from repro.models import encdec as jencdec
from repro.models import vision_lm as jvlm
from repro.runtime import server as jserver
from repro_torch import bridge
from repro_torch.configs.base import ControllerConfig, PagedKVConfig
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.core.sparse_mlp import MLP_STAT_KEYS, SHARD_RIDER_KEYS
from repro_torch.launch.specs import model_module
from repro_torch.layers import norms as tnorms
from repro_torch.models import encdec as tencdec
from repro_torch.models import vision_lm as tvlm
from repro_torch.runtime import server as tserver

# family -> (arch, reference module, port module, extra input name, the
# config field of its length)
FAMILIES = {
    "encdec": ("seamless-m4t-medium", jencdec, tencdec, "frames",
               "n_frames"),
    "vlm": ("llama-3.2-vision-90b", jvlm, tvlm, "images",
            "n_image_tokens"),
}
B, PLEN, STEPS, MAX_LEN = 2, 10, 4, 16
TOL = {"float32": 1e-4, "int8": 5e-3}
QG = 16                                            # int8 quant group width
CHUNK = 8
VALID = np.asarray([20, 13], np.int32)      # 3 chunks; the last is ragged


def _cfgs(fam: str, mode: str = "pallas", kv: str = "float32",
          d_ff: int = 0, **sparse_kw):
    """(reference config, port config): ``mode`` a strategy (sparse) or
    "dense" (sparsity off); ``d_ff`` replaces the reduced width."""
    out = []
    for reduced in (j_reduced, t_reduced):
        cfg = reduced(FAMILIES[fam][0])
        out.append(cfg.replace(
            kv_cache_dtype=kv, d_ff=d_ff or cfg.d_ff,
            sparse=dataclasses.replace(
                cfg.sparse, strategy="pallas" if mode == "dense" else mode,
                enabled=mode != "dense", **sparse_kw)))
    return out


@functools.lru_cache(maxsize=None)
def _ref_tree(fam: str, d_ff: int = 0) -> dict:
    """The reference's weights (numpy leaves) with every norm scale and
    bias, QKV bias and gate drawn from a seeded generator: LayerNorm
    scales 1 + 0.3 N(0, 1), RMSNorm's (1 + scale form) 0.3 N(0, 1), biases
    0.3 N(0, 1), gates +-U(0.3, 0.9)."""
    jcfg, _ = _cfgs(fam, d_ff=d_ff)
    tree = jax.tree.map(np.asarray, FAMILIES[fam][1].init_lm(
        jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    layer = jcfg.norm == "layernorm"

    def perturb(node):
        for k, v in node.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("gate_attn", "gate_mlp"):
                g = rng.uniform(0.3, 0.9, v.shape) * rng.choice([-1, 1],
                                                                v.shape)
                node[k] = g.astype(v.dtype)
            elif k in ("scale", "bias", "bq", "bk", "bv"):
                z = rng.standard_normal(v.shape) * 0.3
                node[k] = (z + (k == "scale" and layer)).astype(v.dtype)
    perturb(tree)
    return tree


def _params(fam: str, jcfg, tcfg, sparse: bool, d_ff: int = 0):
    """Both sides' params; ``sparse``: through each side's
    ``prepare_sparse`` with its config (int8 weights quantized)."""
    tree = _ref_tree(fam, d_ff)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = bridge.params_from_numpy(tree, tcfg, device="cpu")
    if sparse:
        jp = FAMILIES[fam][1].prepare_sparse(jp, jcfg.sparse)
        tp = FAMILIES[fam][2].prepare_sparse(tp, tcfg.sparse)
    return jp, tp


def _extra(fam: str, cfg, b: int, seed: int) -> np.ndarray:
    """Stub frames or images (b, T, d) float32 from a seeded generator."""
    n = getattr(cfg, FAMILIES[fam][4])
    return np.random.default_rng(seed).standard_normal(
        (b, n, cfg.d_model), dtype=np.float32)


def _alphas(cfg, per_slot: bool = True) -> np.ndarray:
    """(L, B) per-slot alphas (the schedule +-0.25), or the (L,)
    schedule."""
    a = cfg.sparse.alpha_schedule().alphas(cfg.n_layers)
    if not per_slot:
        return a
    return a[:, None] + np.asarray([0.25, -0.25], np.float32)[None, :]


def _same_stats(tst, jst, msg, riders: bool = False):
    """Every stat equal; ``riders``: the per-shard riders too."""
    keys = MLP_STAT_KEYS + (SHARD_RIDER_KEYS if riders else ())
    assert set(tst) == set(jst) == set(keys), (set(tst), set(jst))
    for k in keys:
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]),
                                      err_msg=f"{msg} {k}")


def _close(a, b, tol, msg):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol,
                               err_msg=msg)


def prefill_decode(fam: str, jcfg, tcfg, jp, tp, tol: float,
                   per_slot: bool = True, seed: int = 0,
                   riders: bool = False) -> None:
    """A 10-token prefill (logits within 1e-4), then 4 teacher-forced
    decode steps at (L, B) or (L,) alphas: each step's logits within
    ``tol``, its MLP stats equal (``riders``: the per-shard riders
    too)."""
    jm, tm = FAMILIES[fam][1], FAMILIES[fam][2]
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, jcfg.vocab, size=(B, PLEN))
    forced = rng.integers(0, jcfg.vocab, size=(STEPS, B, 1))
    ex = _extra(fam, jcfg, B, seed + 1)
    alphas = _alphas(jcfg, per_slot)
    jl, jc = jax.jit(functools.partial(jm.prefill, cfg=jcfg,
                                       max_len=MAX_LEN))(
        jp, tokens=jnp.asarray(prompt), **{FAMILIES[fam][3]: ex})
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, tcfg, torch.from_numpy(prompt),
                            torch.from_numpy(ex), MAX_LEN)
    _close(tl, jl, TOL["float32"], "prefill")
    jstep = jax.jit(functools.partial(jm.decode_step, cfg=jcfg,
                                      collect_stats=True))
    for t in range(STEPS):
        lens = np.full(B, PLEN + t, np.int32)
        jl, jc, jst = jstep(jp, token=jnp.asarray(forced[t]), caches=jc,
                            cache_len=jnp.asarray(lens),
                            alphas=jnp.asarray(alphas))
        with torch.inference_mode():
            tl, tc, tst = tm.decode_step(
                tp, tcfg, torch.from_numpy(forced[t]), tc,
                torch.from_numpy(lens), alphas=alphas, collect_stats=True)
        _close(tl, jl, tol, f"step {t}")
        _same_stats(tst, jst, f"step {t}", riders)


# strategy, KV dtype, int8 MLP weights, d_ff, per-slot alphas
DECODE_CASES = {
    "pallas": ("pallas", "float32", "", 0, True),
    "pallas-layer-alphas": ("pallas", "float32", "", 0, False),
    "dense": ("dense", "float32", "", 0, True),
    "masked-512": ("masked", "float32", "", 512, True),
    "gather-512": ("gather", "float32", "", 512, True),
    "pallas-int8-weights": ("pallas", "float32", "int8", 512, True),
    "gather-int8-weights": ("gather", "float32", "int8", 512, True),
    "pallas-int8-kv": ("pallas", "int8", "", 0, True),
}


def check_decode_case(fam: str, case: str) -> None:
    mode, kv, weights, d_ff, per_slot = DECODE_CASES[case]
    jcfg, tcfg = _cfgs(fam, mode, kv, d_ff, weight_dtype=weights,
                       quant_group_size=QG)
    jp, tp = _params(fam, jcfg, tcfg, mode != "dense", d_ff)
    prefill_decode(fam, jcfg, tcfg, jp, tp, TOL[kv], per_slot, seed=7)


def _ref_cache(jc: dict, part: str, i: int) -> dict:
    return {name: np.asarray(buf[i]) for name, buf in jc[part].items()}


def check_prefill_chunk(fam: str, mode: str) -> None:
    """A 3-chunk prompt (chunks of 8, the last ragged, per-slot valid) of
    sparse prefill through ``prefill_chunk``, the frames encoded once (an
    encoder-decoder's ``encode`` within 1e-5 first): each chunk's logits
    within 1e-4 and stats equal; the self and cross caches within 1e-5."""
    jm, tm, name = FAMILIES[fam][1:4]
    jcfg, tcfg = _cfgs(fam, mode, sparse_prefill=True)
    jp, tp = _params(fam, jcfg, tcfg, mode != "dense")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab, size=(B, 3 * CHUNK))
    ex = _extra(fam, jcfg, B, 3)
    jex, tex = jnp.asarray(ex), torch.from_numpy(ex)
    if fam == "encdec":
        jex = jencdec.encode(jp, jcfg, jex)
        with torch.inference_mode():
            tex = tencdec.encode(tp, tcfg, tex)
        _close(tex, jex, 1e-5, "encode")
    alphas = _alphas(jcfg)
    jc = jm.init_caches(jcfg, B, 32)
    tc = tm.init_caches(tcfg, B, 32, device="cpu")
    jchunk = jax.jit(functools.partial(jm.prefill_chunk, cfg=jcfg,
                                       collect_stats=True))
    for off in range(0, 3 * CHUNK, CHUNK):
        piece = tokens[:, off:off + CHUNK]
        jl, jc, jst = jchunk(jp, tokens=jnp.asarray(piece), caches=jc,
                             offset=jnp.int32(off), valid=jnp.asarray(VALID),
                             alphas=jnp.asarray(alphas),
                             **{"enc_out" if fam == "encdec" else name: jex})
        with torch.inference_mode():
            tl, tc, tst = tm.prefill_chunk(
                tp, tcfg, torch.from_numpy(piece), tc, off,
                torch.from_numpy(VALID), tex, alphas=alphas,
                collect_stats=True)
        _close(tl, jl, TOL["float32"], f"chunk at {off}")
        _same_stats(tst, jst, f"chunk at {off}")
    for part, ref_part in (("blocks", "self"), ("cross", "cross")):
        assert len(tc[part]) == np.asarray(jc[ref_part]["k"]).shape[0]
        for i, layer in enumerate(tc[part]):
            want = _ref_cache(jc, ref_part, i)
            assert set(layer) == set(want)
            for n, buf in layer.items():
                assert buf.dtype == getattr(torch, want[n].dtype.name)
                _close(buf, want[n], 1e-5, f"{part} {i} {n}")
    assert not any(float(c["k"].abs().max()) == 0 for c in tc["cross"])


def check_sharded_decode(fam: str) -> None:
    """tp_shards=2 at d_ff=512 (shard-local selections of 32 groups),
    strategy pallas: logits within 1e-4, stats and the per-shard riders
    equal."""
    jcfg, tcfg = _cfgs(fam, "pallas", d_ff=512, tp_shards=2)
    jp, tp = _params(fam, jcfg, tcfg, True, 512)
    prefill_decode(fam, jcfg, tcfg, jp, tp, TOL["float32"], seed=5,
                   riders=True)


def _flatten(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, node


def check_prepare_sparse(fam: str, weights: str) -> None:
    """``prepare_sparse`` leaf for leaf in every block list (the encoder's
    MLPs and the cross blocks' too): with int8 weights every MLP quantized
    as the reference quantizes it; the bridge's lists the reference's
    stacks."""
    jcfg, tcfg = _cfgs(fam, "pallas", d_ff=512, weight_dtype=weights,
                       quant_group_size=QG)
    jp, tp = _params(fam, jcfg, tcfg, True, 512)
    jtree = jax.tree.map(np.asarray, jp)
    lists = [k for k, v in tp.items() if isinstance(v, list)]
    assert sorted(lists) == sorted(bridge._block_lists(tcfg))
    for part in lists:
        assert len(tp[part]) == _n_leading(jtree[part])
        for i, blk in enumerate(tp[part]):
            flat_t = dict(_flatten(blk))
            flat_j = dict(_flatten(jax.tree.map(lambda a: a[i],
                                                jtree[part])))
            assert set(flat_t) == set(flat_j), set(flat_t) ^ set(flat_j)
            for name, v in flat_j.items():
                got = flat_t[name]
                assert got.dtype == getattr(torch, v.dtype.name), name
                np.testing.assert_array_equal(got.numpy(), v,
                                              err_msg=f"{part} {i} {name}")
            mlp = blk["mlp"]
            if weights == "int8":
                assert mlp["wg_q"].dtype == torch.int8 and "wg_t" not in mlp
            else:
                assert mlp["wg_t"].dtype == torch.float32
            assert "sign_wg" in mlp
    for k in set(tp) - set(lists):
        for name, v in _flatten(jtree[k]):
            np.testing.assert_array_equal(dict(_flatten(tp[k]))[name].numpy(),
                                          v)


def _n_leading(node) -> int:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.shape[0]


# ---------------------------------------------------------------- servers --

class _RefShim:
    """The reference model module with a ``decode_step`` that drops a None
    ``block_table`` (which the reference's controller decode passes and
    these families' ``decode_step`` does not take) and otherwise calls the
    reference's ``decode_step`` unchanged; every other name is the
    module's own."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def decode_step(self, *args, block_table=None, **kw):
        assert block_table is None
        return self._mod.decode_step(*args, **kw)


def _requests(seed: int, n: int, vocab: int, cls):
    """``n`` mixed-tier requests of 5-14 prompt tokens, 4-7 new tokens
    each."""
    rng = np.random.default_rng(seed)
    slas = ("latency", "balanced", "quality")
    return [cls(uid=i, prompt=rng.integers(0, vocab, size=int(
                rng.integers(5, 15))),
                max_new=int(rng.integers(4, 8)), sla=slas[i % 3])
            for i in range(n)]


def _servers(fam: str, chunk: int, *, ctrl: bool = False, buckets=(),
             d_ff: int = 0):
    """The reference's and the port's servers on the same weights and
    extra inputs (batch 2, max_len 32), strategy pallas; ``chunk``: chunked
    sparse prefill in chunks of that size (0: monolithic); ``ctrl``: the
    per-tier controller."""
    jm, tm, name = FAMILIES[fam][1:4]
    jcfg, tcfg = _cfgs(fam, "pallas", d_ff=d_ff, capacity_buckets=buckets,
                       sparse_prefill=bool(chunk))
    jp, tp = _params(fam, jcfg, tcfg, False, d_ff)
    ex = _extra(fam, jcfg, 2, 11)
    kw = dict(batch=2, max_len=32, prefill_chunk=chunk, prefill_interleave=2)
    jkw, tkw = dict(kw), dict(kw)
    if ctrl:
        # fn_budget 0.5: the false-negative term (reduced dims mispredict
        # often) must not hold alpha up, or the union never leaves the top
        # rung
        ccfg = dict(enabled=True, target_density=0.2, gain=1.0, ema=0.5,
                    audit_period=4, fn_budget=0.5, per_tier=True,
                    prefill_weight=0.5)
        jkw["controller"] = JControllerConfig(**ccfg)
        tkw["controller"] = ControllerConfig(**ccfg)
    jsrv = jserver.Server(_RefShim(jm), jcfg, jserver.ServeConfig(**jkw), jp,
                          extra_inputs={name: jnp.asarray(ex)})
    tsrv = tserver.Server(tm, tcfg, tserver.ServeConfig(**tkw), tp,
                          extra_inputs={name: ex}, device="cpu")
    return jsrv, tsrv


def _record_buckets(jsrv) -> list:
    seen = []
    select = jsrv._select_bucket

    def recording_select():
        seen.append(select())
        return seen[-1]
    jsrv._select_bucket = recording_select
    return seen


def _report_close(a, b, path=""):
    """Reports equal: ints, bools and strings exactly, floats to 1e-5."""
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _report_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _report_close(x, y, f"{path}[{i}]")
    elif isinstance(b, float):
        assert abs(a - b) <= 1e-5, (path, a, b)
    else:
        assert a == b, (path, a, b)


def check_serve(fam: str, chunk: int, monkeypatch, *, ctrl: bool = False,
                buckets=(), d_ff: int = 0, n: int = 5) -> None:
    """Both servers on one queue of ``n`` mixed-tier requests, more than
    the 2 slots (so slots refill and the refill splices the cross caches
    too): every request's tokens equal, the same prefill chunks run, the
    encoder run once an admission (never per chunk); with the controller
    its report and the bucket sequence equal."""
    jsrv, tsrv = _servers(fam, chunk, ctrl=ctrl, buckets=buckets, d_ff=d_ff)
    encodes = [0]
    if fam == "encdec":
        encode = tencdec.encode

        def counting(*args, **kw):
            encodes[0] += 1
            return encode(*args, **kw)
        monkeypatch.setattr(tencdec, "encode", counting)
    j_buckets = _record_buckets(jsrv)
    vocab = tsrv.cfg.vocab
    jdone = jsrv.serve(_requests(3, n, vocab, jserver.Request))
    tdone = tsrv.serve(_requests(3, n, vocab, tserver.Request))
    for jr, tr in zip(sorted(jdone, key=lambda r: r.uid),
                      sorted(tdone, key=lambda r: r.uid)):
        assert tr.outcome == jr.outcome == "completed"
        np.testing.assert_array_equal(tr.out, jr.out, err_msg=f"uid {tr.uid}")
    assert tsrv.prefill_chunks_run == jsrv.prefill_chunks_run
    if chunk:
        assert tsrv.prefill_chunks_run > n
    if fam == "encdec":
        assert encodes[0] == n
    if ctrl:
        _report_close(tsrv.controller.report(), jsrv.controller.report())
        assert list(tsrv.bucket_history) == j_buckets
        if buckets:
            assert set(tsrv.bucket_history) <= {16, 32, 64}


def check_generate(fam: str) -> None:
    """``generate()`` on the whole batch's extra inputs: equal tokens."""
    jsrv, tsrv = _servers(fam, 0)
    prompts = np.random.default_rng(4).integers(
        0, tsrv.cfg.vocab, size=(2, 9)).astype(np.int32)
    np.testing.assert_array_equal(tsrv.generate(prompts, 6),
                                  np.asarray(jsrv.generate(prompts, 6)))


def check_paged_refused(fam: str) -> None:
    """No paged decode for the family: both servers refuse ``paged_kv``."""
    jm, tm, name = FAMILIES[fam][1:4]
    jcfg, tcfg = _cfgs(fam)
    jp, tp = _params(fam, jcfg, tcfg, False)
    ex = _extra(fam, jcfg, 2, 0)
    with pytest.raises(ValueError, match="paged"):
        jserver.Server(jm, jcfg, jserver.ServeConfig(
            batch=2, max_len=32, paged_kv=JPagedKVConfig(block_size=8)), jp,
            extra_inputs={name: jnp.asarray(ex)})
    with pytest.raises(ValueError, match="paged"):
        tserver.Server(tm, tcfg, tserver.ServeConfig(
            batch=2, max_len=32, paged_kv=PagedKVConfig(block_size=8)), tp,
            extra_inputs={name: ex}, device="cpu")
    with pytest.raises(NotImplementedError):
        tm.decode_step(tp, tcfg, torch.zeros((2, 1), dtype=torch.long),
                       tm.init_caches(tcfg, 2, 8, device="cpu"),
                       torch.zeros(2, dtype=torch.long),
                       block_table=torch.zeros((2, 1), dtype=torch.int32))


def check_cache_helpers(fam: str) -> None:
    """``_splice_slot`` copies a finished prefill into its slot in every
    list of the cache tree (the cross K/V too, over what the slot's
    previous request left there), and nothing else; ``_clone_caches``
    copies every list (no leaf aliased)."""
    _, tcfg = _cfgs(fam)
    tm = FAMILIES[fam][2]
    full = tm.init_caches(tcfg, 3, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for layers in full.values():
        for layer in layers:
            for buf in layer.values():
                buf.copy_(torch.randn(buf.shape, generator=gen))
    before = tserver._clone_caches(full)
    one = tm.init_caches(tcfg, 1, 16, device="cpu")
    for layers in one.values():
        for layer in layers:
            for buf in layer.values():
                buf.copy_(torch.randn(buf.shape, generator=gen))
    tserver._splice_slot(full, one, 1)
    assert set(full) == {"blocks", "cross"}
    for part in full:
        for f, o, b in zip(full[part], one[part], before[part]):
            for name, buf in f.items():
                assert torch.equal(buf[1:2], o[name]), (part, name)
                assert torch.equal(buf[0], b[name][0])
                assert torch.equal(buf[2], b[name][2])
                assert buf.data_ptr() != b[name].data_ptr()


def check_entry_points_default_to_the_card(fam: str) -> None:
    """Without a GPU ``init_lm``, ``init_caches``, the bridge and ``Server``
    raise unless asked for ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, tcfg = _cfgs(fam)
    tm = FAMILIES[fam][2]
    params = tm.init_lm(tcfg, device="cpu")
    for call in (lambda: tm.init_lm(tcfg),
                 lambda: tm.init_caches(tcfg, 2, 8),
                 lambda: bridge.params_from_numpy(_ref_tree(fam), tcfg),
                 lambda: tserver.Server(tm, tcfg, tserver.ServeConfig(),
                                        params)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def check_cli(fam: str) -> None:
    """The serve CLI at reduced dims on the CPU, its stub inputs drawn as
    the reference's CLI draws them: every request completes, nothing
    launches a kernel."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    ops.reset_launch_counts()
    rep = serve_cli.main(["--arch", FAMILIES[fam][0], "--reduced",
                          "--device", "cpu", "--requests", "3", "--batch",
                          "2", "--max-new", "4"])
    assert rep["completed"] == 3 and rep["tokens"] == 12
    assert sum(ops.launch_counts().values()) == 0


# ------------------------------------------------------------ encdec tests --

FAM = "encdec"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """LayerNorm (float32 statistics, eps 1e-5, scale and bias, cast back)
    within 1e-5 (bf16: the same bf16 values)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 2 + 0.5
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    jx = jnp.asarray(x, dtype)
    want = jnorms.layernorm(jax.tree.map(jnp.asarray, p), jx)
    got = tnorms.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=0,
                               atol=1e-5 if dtype == "float32" else 0)
    init = tnorms.init_layernorm(8)
    assert torch.equal(init["scale"], torch.ones(8))
    assert torch.equal(init["bias"], torch.zeros(8))


def test_encode_matches_reference():
    """The non-causal encoder with its dense FFNs: states within 1e-5 of
    the reference's, and not causal (the first frame's state moves when
    the last frame does)."""
    jcfg, tcfg = _cfgs(FAM)
    jp, tp = _params(FAM, jcfg, tcfg, True)
    frames = _extra(FAM, jcfg, B, 0)
    want = jencdec.encode(jp, jcfg, jnp.asarray(frames))
    with torch.inference_mode():
        got = tencdec.encode(tp, tcfg, torch.from_numpy(frames))
        _close(got, want, 1e-5, "encode")
        moved = frames.copy()
        moved[:, -1] += 1.0
        other = tencdec.encode(tp, tcfg, torch.from_numpy(moved))
    assert not torch.allclose(other[:, 0], got[:, 0])


def test_layout_and_bridge():
    """The bridge's lists: 2 encoder and 2 decoder layers, each decoder
    layer with its self and cross attention, LayerNorm scales and biases
    carried over."""
    jcfg, tcfg = _cfgs(FAM)
    tree = _ref_tree(FAM)
    tp = bridge.params_from_numpy(tree, tcfg, device="cpu")
    assert len(tp["enc_blocks"]) == tcfg.n_enc_layers == 2
    assert len(tp["dec_blocks"]) == tcfg.n_layers == 2
    assert set(tp["dec_blocks"][1]) == {"ln1", "attn", "ln_x", "cross",
                                        "ln2", "mlp"}
    np.testing.assert_array_equal(tp["dec_blocks"][1]["ln_x"]["bias"],
                                  tree["dec_blocks"]["ln_x"]["bias"][1])
    assert "wu_t" not in tp["dec_blocks"][0]["mlp"]       # ungated
    assert model_module(tcfg) is tencdec
    init = tencdec.init_lm(tcfg, device="cpu")
    assert [len(init[k]) for k in ("enc_blocks", "dec_blocks")] == [2, 2]
    with pytest.raises(ValueError, match="enc_blocks"):
        bridge.params_from_numpy(tree, tcfg.replace(n_enc_layers=3),
                                 device="cpu")


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_prefill_and_decode_teacher_forced(case):
    check_decode_case(FAM, case)


@pytest.mark.parametrize("mode", ["pallas", "dense"])
def test_prefill_chunk_teacher_forced(mode):
    check_prefill_chunk(FAM, mode)


def test_sharded_decode_matches_reference():
    check_sharded_decode(FAM)


@pytest.mark.parametrize("weights", ["", "int8"])
def test_prepare_sparse_every_block_list(weights):
    check_prepare_sparse(FAM, weights)


@pytest.mark.parametrize("chunk", [0, CHUNK])
def test_serve_matches_reference(chunk, monkeypatch):
    check_serve(FAM, chunk, monkeypatch)


def test_controller_serve_matches_reference(monkeypatch):
    check_serve(FAM, CHUNK, monkeypatch, ctrl=True,
                buckets=(0.25, 0.5, 1.0), d_ff=512)


def test_generate_matches_reference():
    check_generate(FAM)


def test_paged_kv_refused():
    check_paged_refused(FAM)


def test_cache_helpers_walk_every_list():
    check_cache_helpers(FAM)


def test_serve_cli_runs():
    check_cli(FAM)


def test_entry_points_default_to_the_card():
    check_entry_points_default_to_the_card(FAM)
