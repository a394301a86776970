"""The hybrid family through the port against the JAX package:
zamba2-1.2b at its ``reduced_config`` (``attn_every=2``: two groups of
the shared attention block and 2 Mamba2 layers, then one tail layer; SSM
state and head 16, d_ff 128, LoRA rank 8), with the reference's weights
carried over by ``repro_torch.bridge``.

The reference starts every RMSNorm scale, every ``lora_b_q``, the conv
biases and the skip ``D`` where a parity test would pass with them wrong
or missing (``lora_b_q`` 0 makes each invocation's LoRA delta 0, ``D`` 1
hides a transposed skip).  Here each gets a seeded random value on both
sides: norm scales 0.3 N(0, 1) (the 1 + scale form), ``lora_b_q`` and
the conv biases 0.3 N(0, 1), ``D`` U(0.5, 1.5), ``dt_bias`` shifted by
0.3 N(0, 1).  Token inputs come from a seeded numpy generator, and the
per-slot alphas differ in every row (the schedule plus a row ramp plus
slot offsets), so an invocation reading another layer's row shows in its
stats.

Tolerances, as ``tests/test_torch_archs.py`` holds the dense archs:
logits within 1e-4 with a float32 KV cache and 5e-3 with int8 KV; the
Mamba2 layer's outputs and every recurrent state (SSM state, conv tail)
and KV cache within 1e-5 x the largest magnitude of the reference's
tensor; MLP stats (n_inv, B), selections, a server's tokens, controller
report (floats to 1e-5) and bucket sequence exactly.  At
``reduced_config`` k=128 is 16 row groups, all selected; the cases at
``d_ff=512`` (64 groups, capacity 32) make the clamp bind and give the
bucket ladder its rungs (16/32/64 groups).

The Mamba2 scan runs in chunks of the largest divisor of the prompt
length not above ``ssm_chunk``: the layer cases take ``ssm_chunk=16`` at
lengths 2, 7 (one chunk each), 16 (one full chunk), 37 (a prime: 37
chunks of 1) and 40 (4 chunks of 10).
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ControllerConfig as JControllerConfig
from repro.configs.base import PagedKVConfig as JPagedKVConfig
from repro.configs.registry import reduced_config as j_reduced
from repro.layers import mamba2 as jm2
from repro.models import lm as jlm
from repro.runtime import server as jserver
from repro_torch import bridge
from repro_torch.configs.base import ControllerConfig, PagedKVConfig
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.layers import mamba2 as tm2
from repro_torch.launch.specs import model_module
from repro_torch.models import lm as tlm
from repro_torch.runtime import server as tserver
from test_torch_encdec import (_close, _record_buckets, _report_close,
                               _requests, _same_stats)

ARCH = "zamba2-1.2b"
B, PLEN, STEPS, MAX_LEN = 2, 10, 4, 16
TOL = {"float32": 1e-4, "int8": 5e-3}
STATE_TOL = 1e-5                  # x max |reference|
QG = 16                           # int8 quant group width
LAYER_LENS = (2, 7, 16, 37, 40)


def _cfgs(mode: str = "pallas", kv: str = "float32", d_ff: int = 0,
          lora: int = 8, **sparse_kw):
    """(reference config, port config): ``mode`` a strategy (sparse) or
    "dense" (sparsity off); ``d_ff`` replaces the reduced width; ``lora``
    the shared block's LoRA rank (0: none)."""
    out = []
    for reduced in (j_reduced, t_reduced):
        cfg = reduced(ARCH)
        out.append(cfg.replace(
            kv_cache_dtype=kv, d_ff=d_ff or cfg.d_ff, shared_lora_rank=lora,
            sparse=dataclasses.replace(
                cfg.sparse, strategy="pallas" if mode == "dense" else mode,
                enabled=mode != "dense", **sparse_kw)))
    return out


def _perturb(node, rng) -> None:
    """In place, over a numpy tree: the leaves the reference starts at a
    value that hides a fault, drawn from ``rng``."""
    for k, v in node.items():
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k in ("scale", "lora_b_q", "conv_b"):
            node[k] = (rng.standard_normal(v.shape) * 0.3).astype(v.dtype)
        elif k == "D":
            node[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        elif k == "dt_bias":
            node[k] = (v + rng.standard_normal(v.shape) * 0.3).astype(
                v.dtype)


@functools.lru_cache(maxsize=None)
def _ref_tree(d_ff: int = 0, lora: int = 8) -> dict:
    """The reference's weights (numpy leaves), perturbed."""
    jcfg, _ = _cfgs(d_ff=d_ff, lora=lora)
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0),
                                                jcfg))
    _perturb(tree, np.random.default_rng(1))
    return tree


def _params(jcfg, tcfg, sparse: bool, d_ff: int = 0, lora: int = 8):
    """Both sides' params; ``sparse``: through each side's
    ``prepare_sparse`` with its config (int8 weights quantized)."""
    tree = _ref_tree(d_ff, lora)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = bridge.params_from_numpy(tree, tcfg, device="cpu")
    if sparse:
        jp = jlm.prepare_sparse(jp, jcfg.sparse)
        tp = tlm.prepare_sparse(tp, tcfg.sparse)
    return jp, tp


def _alphas(cfg, per_slot: bool = True) -> np.ndarray:
    """(L, B) alphas, every row different (the schedule plus a ramp over
    the rows plus slot offsets +-0.25), or the (L,) schedule."""
    a = cfg.sparse.alpha_schedule().alphas(cfg.n_layers)
    if not per_slot:
        return a
    ramp = np.linspace(-0.3, 0.3, cfg.n_layers, dtype=np.float32)
    return ((a + ramp)[:, None]
            + np.asarray([0.25, -0.25], np.float32)[None, :])


def _rel_close(got, want, tol, msg):
    """``got`` (a tensor) within ``tol`` x max |want| of ``want``, the
    same dtype."""
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        want = want.astype(np.float32)
        assert got.dtype == torch.bfloat16, msg
        got = got.float()
    else:
        assert got.dtype == getattr(torch, want.dtype.name), (msg, got.dtype)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * scale,
                               err_msg=msg)


def _state_dict(state) -> dict:
    """A reference state (a NamedTuple) or KV cache (a dict) as a dict."""
    return dict(state._asdict()) if hasattr(state, "_asdict") else \
        dict(state)


def ref_caches(jc: dict) -> dict:
    """The reference's caches in the port's layout: ``mamba`` leaves
    (n_inv, attn_every, B, ...) as a flat list in layer order, ``attn``
    (n_inv, B, ...) and ``tail`` (n_tail, B, ...) one entry each."""
    out = {}
    for part, node in jc.items():
        leaves = {k: np.asarray(v) for k, v in _state_dict(node).items()}
        lead = 2 if part == "mamba" else 1
        n = int(np.prod(next(iter(leaves.values())).shape[:lead]))
        flat = {k: v.reshape((n,) + v.shape[lead:]) for k, v in
                leaves.items()}
        out[part] = [{k: v[i] for k, v in flat.items()} for i in range(n)]
    return out


def check_caches(tc: dict, jc: dict, msg: str) -> None:
    want = ref_caches(jc)
    assert set(tc) == set(want), (set(tc), set(want))
    for part in want:
        assert len(tc[part]) == len(want[part]), part
        for i, (got, ref) in enumerate(zip(tc[part], want[part])):
            assert set(got) == set(ref), (part, set(got), set(ref))
            for name in ref:
                _rel_close(got[name], ref[name], STATE_TOL,
                           f"{msg}: {part}[{i}] {name}")


def prefill_decode(jcfg, tcfg, jp, tp, tol: float, per_slot: bool = True,
                   seed: int = 0, riders: bool = False) -> None:
    """A 10-token prefill (logits within 1e-4, the caches within
    ``STATE_TOL``), then 4 teacher-forced decode steps at (L, B) or (L,)
    alphas: each step's logits within ``tol``, its (n_inv, B) stats equal
    (``riders``: the per-shard riders too), and the caches after the last
    step within ``STATE_TOL`` (float32 KV)."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, jcfg.vocab, size=(B, PLEN))
    forced = rng.integers(0, jcfg.vocab, size=(STEPS, B, 1))
    alphas = _alphas(jcfg, per_slot)
    jl, jc = _ref_prefill(jcfg, jp, prompt)
    with torch.inference_mode():
        tl, tc = tlm.prefill(tp, tcfg, torch.from_numpy(prompt), MAX_LEN)
    _close(tl, jl, TOL["float32"], "prefill")
    if tcfg.kv_cache_dtype == "float32":
        check_caches(tc, jc, "prefill")
    jstep = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg,
                                      collect_stats=True))
    for t in range(STEPS):
        lens = np.full(B, PLEN + t, np.int32)
        jl, jc, jst = jstep(jp, token=jnp.asarray(forced[t]), caches=jc,
                            cache_len=jnp.asarray(lens),
                            alphas=jnp.asarray(alphas))
        with torch.inference_mode():
            tl, tc, tst = tlm.decode_step(
                tp, tcfg, torch.from_numpy(forced[t]), tc,
                torch.from_numpy(lens), alphas=alphas, collect_stats=True)
        _close(tl, jl, tol, f"step {t}")
        _same_stats(tst, jst, f"step {t}", riders)
        assert tst["realized_density"].shape[:2] == (
            tcfg.n_layers // tcfg.attn_every, B)
    if tcfg.kv_cache_dtype == "float32":
        check_caches(tc, jc, "after decode")


def _ref_prefill(jcfg, jp, prompt):
    return jax.jit(functools.partial(jlm.prefill, cfg=jcfg,
                                     max_len=MAX_LEN))(
        jp, tokens=jnp.asarray(prompt))


# strategy, KV dtype, int8 MLP weights, d_ff, per-slot alphas, LoRA rank
DECODE_CASES = {
    "pallas": ("pallas", "float32", "", 0, True, 8),
    "pallas-layer-alphas": ("pallas", "float32", "", 0, False, 8),
    "pallas-no-lora": ("pallas", "float32", "", 0, True, 0),
    "dense": ("dense", "float32", "", 0, True, 8),
    "dense-no-lora": ("dense", "float32", "", 0, True, 0),
    "pallas-512": ("pallas", "float32", "", 512, True, 8),
    "masked-512": ("masked", "float32", "", 512, True, 8),
    "gather-512": ("gather", "float32", "", 512, True, 8),
    "pallas-int8-weights": ("pallas", "float32", "int8", 512, True, 8),
    "gather-int8-weights": ("gather", "float32", "int8", 512, True, 8),
    "pallas-int8-kv": ("pallas", "int8", "", 0, True, 8),
}


# ------------------------------------------------------------ the layer --

def _layer_params(seed: int = 3):
    """One reduced Mamba2 layer (ssm_chunk 16), perturbed, on both
    sides."""
    jcfg, _ = _cfgs()
    mc = jlm.mamba_cfg(jcfg.replace(ssm_chunk=16))
    tree = jax.tree.map(np.asarray, jm2.init_mamba2(jax.random.PRNGKey(seed),
                                                    mc))
    _perturb(tree, np.random.default_rng(seed))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    tc = tm2.Mamba2Config(**dataclasses.asdict(mc))
    return mc, tc, jax.tree.map(jnp.asarray, tree), tp


@pytest.mark.parametrize("length", LAYER_LENS)
def test_mamba2_forward_matches_reference(length):
    """``mamba2_forward`` at each length: the output and the state after
    the prompt (SSM state and the pre-activation conv tail, its zero
    padding included at length 2) within ``STATE_TOL``; the chunk is the
    reference's."""
    mc, tc, jp, tp = _layer_params()
    x = np.random.default_rng(length).standard_normal(
        (B, length, mc.d_model)).astype(np.float32)
    jy, jst = jax.jit(functools.partial(jm2.mamba2_forward, cfg=mc,
                                        return_state=True))(
        jp, jnp.asarray(x))
    ty, tst = tm2.mamba2_forward(tp, torch.from_numpy(x), tc,
                                 return_state=True)
    _rel_close(ty, jy, STATE_TOL, "y")
    for name, want in _state_dict(jst).items():
        _rel_close(tst[name], want, STATE_TOL, name)
    assert tm2.chunk_len(length, 16) == {2: 2, 7: 7, 16: 16, 37: 1,
                                         40: 10}[length]
    if length < mc.d_conv - 1:
        assert not bool(tst["conv"][:, :mc.d_conv - 1 - length].any())


def test_mamba2_decode_from_prefill_state():
    """4 ``mamba2_decode`` steps from the state after a 7-token prompt:
    each output and the state within ``STATE_TOL``; and a 9-token forward
    equals 7 tokens then 2 steps, on the port alone."""
    mc, tc, jp, tp = _layer_params(5)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, 7 + 4, mc.d_model)).astype(np.float32)
    _, jst = jm2.mamba2_forward(jp, jnp.asarray(x[:, :7]), mc,
                                return_state=True)
    _, tst = tm2.mamba2_forward(tp, torch.from_numpy(x[:, :7]), tc,
                                return_state=True)
    jdec = jax.jit(functools.partial(jm2.mamba2_decode, cfg=mc))
    for t in range(7, 11):
        jy, jst = jdec(jp, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = tm2.mamba2_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                    tst, tc)
        _rel_close(ty, jy, STATE_TOL, f"step {t}")
        for name, want in _state_dict(jst).items():
            _rel_close(tst[name], want, STATE_TOL, f"step {t} {name}")
    whole, _ = tm2.mamba2_forward(tp, torch.from_numpy(x[:, :9]), tc,
                                  return_state=True)
    _, st = tm2.mamba2_forward(tp, torch.from_numpy(x[:, :7]), tc,
                               return_state=True)
    for t in (7, 8):
        y, st = tm2.mamba2_decode(tp, torch.from_numpy(x[:, t:t + 1]), st,
                                  tc)
        torch.testing.assert_close(y[:, 0], whole[:, t], rtol=0,
                                   atol=1e-5 * float(whole.abs().max()))


# ------------------------------------------------------------ the model --

def test_layout_init_and_bridge():
    """The bridge's lists: 4 grouped Mamba2 layers, 1 tail layer, 2 LoRAs
    and the one shared block (its MLP gated, every RMSNorm scale and
    ``lora_b_q`` carried over non-zero); ``init_lm`` builds the same
    layout; a depth the tree does not hold raises."""
    jcfg, tcfg = _cfgs()
    tree = _ref_tree()
    tp = bridge.params_from_numpy(tree, tcfg, device="cpu")
    assert [len(tp[k]) for k in ("mamba", "mamba_tail", "lora")] == [4, 1, 2]
    assert tlm._hybrid_layout(tcfg) == (2, 4, 1)
    assert set(tp["shared"]) == {"ln1", "attn", "ln2", "mlp"}
    for i, lora in enumerate(tp["lora"]):
        np.testing.assert_array_equal(lora["lora_b_q"].numpy(),
                                      tree["lora"]["lora_b_q"][i])
        assert float(lora["lora_b_q"].abs().min()) > 0
    np.testing.assert_array_equal(tp["mamba"][3]["mixer"]["D"].numpy(),
                                  tree["mamba"]["mixer"]["D"][3])
    assert model_module(tcfg) is tlm
    init = tlm.init_lm(tcfg, device="cpu")
    assert set(init) == set(tp)
    assert [len(init[k]) for k in ("mamba", "mamba_tail", "lora")] == \
        [4, 1, 2]
    assert not bool(init["lora"][0]["lora_b_q"].any())   # 0 at init
    assert "lora" not in tlm.init_lm(tcfg.replace(shared_lora_rank=0),
                                     device="cpu")
    with pytest.raises(ValueError, match="mamba"):
        bridge.params_from_numpy(tree, tcfg.replace(n_layers=7),
                                 device="cpu")
    with pytest.raises(ValueError, match="lora"):
        bridge.params_from_numpy(tree, tcfg.replace(shared_lora_rank=0),
                                 device="cpu")


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_init_caches_match_reference(kv):
    """``init_caches``: every leaf's shape and dtype the reference's
    (SSM states float32, conv tails in ``cfg.dtype``), all zero."""
    jcfg, tcfg = _cfgs(kv=kv)
    jcfg, tcfg = (c.replace(dtype="bfloat16") for c in (jcfg, tcfg))
    want = ref_caches(jlm.init_caches(jcfg, 3, MAX_LEN))
    got = tlm.init_caches(tcfg, 3, MAX_LEN, device="cpu")
    assert set(got) == set(want) == {"mamba", "attn", "tail"}
    for part in want:
        assert len(got[part]) == len(want[part])
        for g, w in zip(got[part], want[part]):
            assert set(g) == set(w)
            for name, v in w.items():
                assert tuple(g[name].shape) == v.shape, (part, name)
                assert g[name].dtype == getattr(
                    torch, v.dtype.name), (part, name, g[name].dtype)
                assert not bool(g[name].any())


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_prefill_and_decode_teacher_forced(case):
    mode, kv, weights, d_ff, per_slot, lora = DECODE_CASES[case]
    jcfg, tcfg = _cfgs(mode, kv, d_ff, lora, weight_dtype=weights,
                       quant_group_size=QG)
    jp, tp = _params(jcfg, tcfg, mode != "dense", d_ff, lora)
    prefill_decode(jcfg, tcfg, jp, tp, TOL[kv], per_slot, seed=7)


def test_sharded_decode_matches_reference():
    """tp_shards=2 at d_ff=512 (shard-local selections of 32 groups),
    strategy pallas: logits within 1e-4, stats and the per-shard riders
    equal."""
    jcfg, tcfg = _cfgs("pallas", d_ff=512, tp_shards=2)
    jp, tp = _params(jcfg, tcfg, True, 512)
    prefill_decode(jcfg, tcfg, jp, tp, TOL["float32"], seed=5, riders=True)


def test_alpha_rows_are_the_invocations():
    """Invocation g reads alpha row g: moving row 1 moves the stats of
    invocation 1 and nothing else; moving row 2 (a Mamba2 layer's)
    changes nothing."""
    jcfg, tcfg = _cfgs("pallas")
    _, tp = _params(jcfg, tcfg, True)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab, size=(B, PLEN)))
    base = _alphas(tcfg)

    def stats(alphas):
        with torch.inference_mode():
            _, c = tlm.prefill(tp, tcfg, tok, MAX_LEN)
            _, _, st = tlm.decode_step(tp, tcfg, tok[:, :1], c,
                                       torch.full((B,), PLEN),
                                       alphas=alphas, collect_stats=True)
        return st["predicted_density"]
    ref = stats(base)
    for row, moved in ((1, {1}), (2, set())):
        alt = base.copy()
        alt[row] = 0.0
        got = stats(alt)
        diff = {g for g in range(2) if not torch.equal(got[g], ref[g])}
        assert diff == moved, (row, diff)
    with pytest.raises(ValueError, match="n_layers"):
        stats(base[:2])


@pytest.mark.parametrize("weights", ["", "int8"])
def test_prepare_sparse_packs_the_shared_block_once(weights):
    """``prepare_sparse`` leaf for leaf the reference's: the shared
    block's MLP packed (int8: quantized) once, the Mamba2 layers and the
    LoRAs untouched."""
    jcfg, tcfg = _cfgs("pallas", d_ff=512, weight_dtype=weights,
                       quant_group_size=QG)
    jp, tp = _params(jcfg, tcfg, True, 512)
    jtree = jax.tree.map(np.asarray, jp)
    flat_t = dict(_flatten(tp))
    flat_j = {}
    for path, v in _flatten(jtree):
        if path[0] in bridge._block_lists(tcfg):
            for i in range(v.shape[0]):
                flat_j[(path[0], i) + path[1:]] = v[i]
        else:
            flat_j[path] = v
    assert set(flat_t) == set(flat_j), set(flat_t) ^ set(flat_j)
    for name, v in flat_j.items():
        got = flat_t[name]
        assert got.dtype == getattr(torch, v.dtype.name), name
        np.testing.assert_array_equal(got.numpy(), v, err_msg=str(name))
    packs = [p for p in flat_t if p[-1] == "sign_wg"]
    assert packs == [("shared", "mlp", "sign_wg")]
    mlp = tp["shared"]["mlp"]
    assert ("wg_q" in mlp) == (weights == "int8")


def _flatten(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _flatten(v, path + (i,))
    else:
        yield path, node


def test_chunked_prefill_and_paged_kv_refused():
    """As in the reference: no ``prefill_chunk`` and no paged pool for
    recurrent state: ``prefill_chunk`` and ``init_kv_pool`` raise
    NotImplementedError on both sides, a ``block_table`` too, and both
    servers refuse ``paged_kv``."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, False)
    with pytest.raises(NotImplementedError):
        jlm.init_kv_pool(jcfg, 4, 8)
    with pytest.raises(NotImplementedError):
        tlm.init_kv_pool(tcfg, 4, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        jlm.prefill_chunk(jp, jcfg, jnp.zeros((1, 8), jnp.int32),
                          jlm.init_caches(jcfg, 1, 16), 0, 8)
    with pytest.raises(NotImplementedError):
        tlm.prefill_chunk(tp, tcfg, torch.zeros((1, 8), dtype=torch.long),
                          tlm.init_caches(tcfg, 1, 16, device="cpu"), 0, 8)
    with pytest.raises(NotImplementedError):
        tlm.decode_step(tp, tcfg, torch.zeros((2, 1), dtype=torch.long),
                        tlm.init_caches(tcfg, 2, 8, device="cpu"),
                        torch.zeros(2, dtype=torch.long),
                        block_table=torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="paged"):
        jserver.Server(jlm, jcfg, jserver.ServeConfig(
            batch=2, max_len=32, paged_kv=JPagedKVConfig(block_size=8)), jp)
    with pytest.raises(ValueError, match="paged"):
        tserver.Server(tlm, tcfg, tserver.ServeConfig(
            batch=2, max_len=32, paged_kv=PagedKVConfig(block_size=8)), tp,
            device="cpu")


# ---------------------------------------------------------------- servers --

def _servers(chunk: int = 0, *, ctrl: bool = False, buckets=(),
             d_ff: int = 0):
    """The reference's and the port's servers on the same weights (batch
    2, max_len 32), strategy pallas; ``chunk``: ``prefill_chunk`` (which
    these families serve monolithically, with a warning); ``ctrl``: the
    per-tier controller."""
    jcfg, tcfg = _cfgs("pallas", d_ff=d_ff, capacity_buckets=buckets)
    jp, tp = _params(jcfg, tcfg, False, d_ff)
    kw = dict(batch=2, max_len=32, prefill_chunk=chunk)
    jkw, tkw = dict(kw), dict(kw)
    if ctrl:
        ccfg = dict(enabled=True, target_density=0.2, gain=1.0, ema=0.5,
                    audit_period=4, fn_budget=0.5, per_tier=True)
        jkw["controller"] = JControllerConfig(**ccfg)
        tkw["controller"] = ControllerConfig(**ccfg)
    jsrv = jserver.Server(jlm, jcfg, jserver.ServeConfig(**jkw), jp)
    tsrv = tserver.Server(tlm, tcfg, tserver.ServeConfig(**tkw), tp,
                          device="cpu")
    return jsrv, tsrv


def check_serve(chunk: int = 0, *, ctrl: bool = False, buckets=(),
                d_ff: int = 0, n: int = 5) -> None:
    """Both servers on one queue of ``n`` mixed-tier requests, more than
    the 2 slots (so slots refill and the refill splices every state):
    every request's tokens equal; with the controller its report and the
    bucket sequence equal."""
    jsrv, tsrv = _servers(chunk, ctrl=ctrl, buckets=buckets, d_ff=d_ff)
    j_buckets = _record_buckets(jsrv)
    vocab = tsrv.cfg.vocab
    jdone = jsrv.serve(_requests(3, n, vocab, jserver.Request))
    tdone = tsrv.serve(_requests(3, n, vocab, tserver.Request))
    for jr, tr in zip(sorted(jdone, key=lambda r: r.uid),
                      sorted(tdone, key=lambda r: r.uid)):
        assert tr.outcome == jr.outcome == "completed"
        np.testing.assert_array_equal(tr.out, jr.out, err_msg=f"uid {tr.uid}")
    assert tsrv.prefill_chunks_run == jsrv.prefill_chunks_run == 0
    if ctrl:
        assert tsrv.controller.num_layers == 2      # the invocations
        _report_close(tsrv.controller.report(), jsrv.controller.report())
        assert list(tsrv.bucket_history) == j_buckets
        if buckets:
            assert set(tsrv.bucket_history) <= {16, 32, 64}


def test_serve_matches_reference():
    check_serve()


def test_controller_serve_matches_reference():
    """The per-tier controller over the 3-rung ladder at d_ff=512: its
    alphas two rows wide (the invocations), padded with ones to the 5
    layers for the decode step."""
    check_serve(ctrl=True, buckets=(0.25, 0.5, 1.0), d_ff=512)


def test_prefill_chunk_warns_and_serves_monolithic():
    """``prefill_chunk=8``: both servers warn that the family has no
    chunked prefill and admit through the monolithic prefill, with the
    same tokens."""
    with pytest.warns(UserWarning, match="has no chunked prefill") as rec:
        check_serve(8)
    assert len([w for w in rec
                if "has no chunked prefill" in str(w.message)]) == 2


def test_generate_matches_reference():
    jsrv, tsrv = _servers()
    prompts = np.random.default_rng(4).integers(
        0, tsrv.cfg.vocab, size=(2, 9)).astype(np.int32)
    np.testing.assert_array_equal(tsrv.generate(prompts, 6),
                                  np.asarray(jsrv.generate(prompts, 6)))


def test_generate_with_controller_pads_alphas():
    """``generate()`` under an untiered controller: its n_inv-wide alphas
    padded for the decode step; tokens and report equal."""
    jcfg, tcfg = _cfgs("pallas")
    jp, tp = _params(jcfg, tcfg, False)
    ccfg = dict(enabled=True, target_density=0.3, gain=1.0, ema=0.5)
    jsrv = jserver.Server(jlm, jcfg, jserver.ServeConfig(
        batch=2, max_len=32, controller=JControllerConfig(**ccfg)), jp)
    tsrv = tserver.Server(tlm, tcfg, tserver.ServeConfig(
        batch=2, max_len=32, controller=ControllerConfig(**ccfg)), tp,
        device="cpu")
    prompts = np.random.default_rng(6).integers(
        0, tcfg.vocab, size=(2, 7)).astype(np.int32)
    np.testing.assert_array_equal(tsrv.generate(prompts, 6),
                                  np.asarray(jsrv.generate(prompts, 6)))
    _report_close(tsrv.controller.report(), jsrv.controller.report())
    assert tsrv._pad_layers(np.full(2, 0.5, np.float32)).tolist() == \
        [0.5, 0.5, 1.0, 1.0, 1.0]


def test_cache_helpers_walk_the_hybrid_tree():
    """``_splice_slot`` copies a finished prefill into its slot in every
    list (Mamba2 states, the invocations' KV, the tail), cast to the full
    tree's dtypes (a float32 conv tail into a bf16 cache), and nothing
    else; ``_clone_caches`` aliases no leaf."""
    _, tcfg = _cfgs()
    full = tlm.init_caches(tcfg.replace(dtype="bfloat16"), 3, 16,
                           device="cpu")
    gen = torch.Generator().manual_seed(0)
    for layers in full.values():
        for layer in layers:
            for buf in layer.values():
                buf.copy_(torch.randn(buf.shape, generator=gen))
    before = tserver._clone_caches(full)
    one = tlm.init_caches(tcfg, 1, 16, device="cpu")
    for layers in one.values():
        for layer in layers:
            for buf in layer.values():
                buf.copy_(torch.randn(buf.shape, generator=gen))
    tserver._splice_slot(full, one, 1)
    assert full["mamba"][0]["conv"].dtype == torch.bfloat16
    for part in full:
        for f, o, b in zip(full[part], one[part], before[part]):
            for name, buf in f.items():
                assert torch.equal(buf[1:2], o[name].to(buf.dtype))
                assert torch.equal(buf[0], b[name][0])
                assert torch.equal(buf[2], b[name][2])
                assert buf.data_ptr() != b[name].data_ptr()


def test_serve_cli_runs():
    """The serve CLI at reduced dims on the CPU, with the per-tier
    controller and with ``--prefill-chunk`` (warned, served whole):
    every request completes, nothing launches a kernel."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    ops.reset_launch_counts()
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--strategy",
            "pallas", "--requests", "4", "--batch", "2", "--max-new", "4"]
    rep = serve_cli.main(base + ["--controller", "--per-tier"])
    assert rep["completed"] == 4 and rep["tokens"] == 16
    assert len(rep["controller"]["tiers"]["balanced"]["alpha_per_layer"]) \
        == 2
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        rep = serve_cli.main(base + ["--prefill-chunk", "8"])
    assert rep["completed"] == 4
    assert rep["prefill"]["prefill_chunks_run"] == 0
    assert any("has no chunked prefill" in str(w.message) for w in rec)
    assert sum(ops.launch_counts().values()) == 0


def test_entry_points_default_to_the_card():
    """Without a GPU ``init_lm``, ``init_caches``, the bridge and ``Server``
    raise unless asked for ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, tcfg = _cfgs()
    params = tlm.init_lm(tcfg, device="cpu")
    for call in (lambda: tlm.init_lm(tcfg),
                 lambda: tlm.init_caches(tcfg, 2, 8),
                 lambda: bridge.params_from_numpy(_ref_tree(), tcfg),
                 lambda: tserver.Server(tlm, tcfg, tserver.ServeConfig(),
                                        params)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
