"""The core and model-layer pieces the dense archs brought into the port,
against the JAX package:

- ``core``: ``predict_sparse`` (the paper's skip mask), the +AS mask
  ``actual_sparsity_mask``, the activation registry against ``jax.nn``,
  ``relufy`` and the package's exports;
- ``models/common.py``: ``temperature_sample``, ``stacked_init`` /
  ``take_layer`` and ``head_logits`` with a softcap; ``embed`` with the
  sqrt(d) scale;
- ``layers/attention.py``: Q/K/V with bias and qk-norm, prefill attention
  with a softcap and a sliding window, the decode attention on the dense
  cache and on both paged routes at lengths on both sides of the window;
- the kernels' host plans at every new full width (the five archs' d, k,
  heads and head dims), on an H100's figures off the card, so a shape a
  kernel does not take shows here before a chip run.

Tolerances are stated where a test compares floats: float32 sums taken in
another order (about 1e-6 here, as the drift between the JAX package and
its own pins, 6e-8 to 1.4e-6) are held to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import predictor as JP
from repro.core import selection as JS
from repro.layers import attention as JA
from repro.layers import embeddings as JE
from repro.models import common as JC
from repro_torch import core as tcore
from repro_torch.configs.registry import get_config
from repro_torch.core import predictor as P
from repro_torch.core import relufication as R
from repro_torch.core import selection as S
from repro_torch.kernels import paged_attn as KA
from repro_torch.kernels import predict as KP
from repro_torch.kernels import ref
from repro_torch.kernels import sign_pack as KS
from repro_torch.kernels import sparse_mlp_fused as KF
from repro_torch.layers import attention as TA
from repro_torch.layers import embeddings as TE
from repro_torch.models import common as TC
from test_torch_chunk_mlp_tc import H100 as CHUNK_H100, SMS
from test_torch_decode_mlp import H100 as DECODE_H100
from test_torch_decode_mlp_q import H100 as DECODE_Q_H100
from test_torch_paged_kv import H100 as PAGED_H100
from test_torch_predict_hopper import _card

ARCHS = ("prosparse-llama2-13b", "qwen3-8b", "qwen1.5-32b", "granite-34b",
         "gemma2-2b")
TOL = dict(rtol=0, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ core --

@pytest.mark.parametrize("alpha", [1.0, 1.03, "per-token"])
def test_predict_sparse_matches_reference(alpha):
    rng = np.random.default_rng(0)
    d, k, b = 200, 96, 5
    w = rng.standard_normal((k, d)).astype(np.float32)
    x = rng.standard_normal((b, d)).astype(np.float32)
    a = (np.asarray([1.0, 1.03, 0.9, 1.5, -1e9], np.float32)
         if alpha == "per-token" else alpha)
    pw, px = JP.pack_signs(jnp.asarray(w)), JP.pack_signs(jnp.asarray(x))
    want = np.asarray(JP.predict_sparse(pw, px, d, jnp.asarray(a)))
    got = P.predict_sparse(_t(pw), _t(px), d,
                           _t(a) if alpha == "per-token" else a)
    assert got.dtype == torch.bool and got.shape == (b, k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size or alpha == "per-token"


@pytest.mark.parametrize("threshold", [0.0, 0.25])
def test_actual_sparsity_mask_matches_reference(threshold):
    h1 = np.random.default_rng(1).standard_normal((4, 64)).astype(np.float32)
    h1[0, :8] = 0.0
    h1[1, :4] = -0.0
    want = np.asarray(JS.actual_sparsity_mask(jnp.asarray(h1), threshold))
    got = S.actual_sparsity_mask(_t(h1), threshold)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_act(name, thr=0.0):
    from repro.core.relufication import get_activation
    return get_activation(name, thr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["relu", "silu", "gelu", "gelu_exact",
                                  "fatrelu"])
def test_activations_match_jax(name, dtype):
    """Each activation on the same inputs (float32 or bfloat16, |x| up to
    10, zeros included): relu and fatrelu exactly; silu, the tanh gelu and
    the erf gelu are libm formulas of their own on either side, held to
    2e-6 in float32.  In bfloat16 the reference rounds its intermediate
    steps (the sigmoid, 1 + tanh, the products) to bfloat16 while the port
    computes the whole activation in float32 and rounds once; an
    intermediate's rounding moves the result by up to a bf16 ulp of x
    (2^-8 |x|, and cancellation in 1 + tanh keeps it there when the value
    is small), so the two are held to 2^-6 |x| (seen: 2^-7.06 |x|)."""
    x = np.random.default_rng(2).uniform(-10, 10, 4096).astype(np.float32)
    x[:4] = (0.0, -0.0, 1e-30, -1e-30)
    jx = jnp.asarray(x, dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    thr = 0.5 if name == "fatrelu" else 0.0
    want = np.asarray(_jax_act(name, thr)(jx).astype(jnp.float32))
    got = R.get_activation(name, thr)(tx).float().numpy()
    if name in ("relu", "fatrelu"):
        np.testing.assert_array_equal(got, want)
    elif dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    else:
        xb = np.asarray(jx.astype(jnp.float32))
        assert (np.abs(got - want) <= 2 ** -6 * np.abs(xb)).all()


def test_activation_registry_and_unknown_name():
    import repro.core.relufication as JR
    assert set(R.ACTIVATIONS) == set(JR.ACTIVATIONS)
    assert R.SPARSIFIABLE == JR.SPARSIFIABLE
    with pytest.raises(ValueError, match="unknown activation"):
        R.get_activation("swish")


@pytest.mark.parametrize("name", ["relu", "fatrelu", "silu", "gelu",
                                  "gelu_exact"])
def test_relufy_matches_reference(name):
    from repro.core.relufication import relufy, is_sparsifiable
    assert R.relufy(name) == relufy(name)
    assert R.is_sparsifiable(R.relufy(name)) and \
        R.is_sparsifiable(name) == is_sparsifiable(name)


def test_core_exports_are_the_references():
    """``repro_torch.core`` exports the reference's names, less the two
    offline permutation helpers (ROADMAP Queue A item 17)."""
    pub = lambda m: {n for n in dir(m) if not n.startswith("_")}  # noqa
    left = {"coactivation_permutation", "apply_neuron_permutation"}
    modules = {"predictor", "relufication", "selection", "sparse_mlp",
               "quantize"}
    assert pub(tcore) - modules == pub(jcore) - modules - left
    assert tcore.MLP_STAT_KEYS == jcore.MLP_STAT_KEYS
    assert tcore.SHARD_RIDER_KEYS == jcore.SHARD_RIDER_KEYS


# ----------------------------------------------------------- models/common

def test_temperature_sample_zero_is_greedy():
    logits = torch.from_numpy(
        np.random.default_rng(3).standard_normal((3, 7, 50)).astype(
            np.float32))
    gen = torch.Generator().manual_seed(0)
    for temp in (0.0, -1.0):
        got = TC.temperature_sample(gen, logits, temp)
        want = np.asarray(JC.temperature_sample(
            jax.random.PRNGKey(0), jnp.asarray(logits.numpy()), temp))
        assert got.dtype == torch.int32 and got.shape == (3, 7)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temp", [0.5, 1.0, 2.0])
def test_temperature_sample_frequencies_follow_softmax(temp):
    """40000 draws over 6 tokens: each token's frequency within 0.015 of
    softmax(logits / T) (5 standard deviations at p = 0.5), the same
    distribution the reference's categorical draws from."""
    logits = torch.tensor([1.0, 0.0, -1.0, 2.0, 0.5, -3.0])
    n = 40000
    gen = torch.Generator().manual_seed(int(temp * 10))
    draws = TC.temperature_sample(gen, logits.expand(n, 6), temp)
    freq = np.bincount(draws.numpy(), minlength=6) / n
    want = np.asarray(jax.nn.softmax(jnp.asarray(logits.numpy()) / temp))
    np.testing.assert_allclose(freq, want, rtol=0, atol=0.015)
    jdraws = np.asarray(JC.temperature_sample(
        jax.random.PRNGKey(1), jnp.broadcast_to(jnp.asarray(logits.numpy()),
                                                (n, 6)), temp))
    np.testing.assert_allclose(np.bincount(jdraws, minlength=6) / n, want,
                               rtol=0, atol=0.015)


def test_stacked_init_and_take_layer():
    def init(gen):
        return {"w": torch.randn((3, 2), generator=gen),
                "ln": {"scale": torch.zeros(2)}}
    stacked = TC.stacked_init(init, torch.Generator().manual_seed(5), 4)
    assert stacked["w"].shape == (4, 3, 2)
    assert stacked["ln"]["scale"].shape == (4, 2)
    # one draw after another from the one generator
    gen = torch.Generator().manual_seed(5)
    for i in range(4):
        torch.testing.assert_close(TC.take_layer(stacked, i)["w"],
                                   torch.randn((3, 2), generator=gen),
                                   rtol=0, atol=0)
    jst = JC.stacked_init(lambda k: {"w": jax.random.normal(k, (3, 2))},
                          jax.random.PRNGKey(0), 4)
    layer = TC.take_layer({"w": _t(jst["w"])}, 2)
    np.testing.assert_array_equal(layer["w"].numpy(),
                                  np.asarray(JC.take_layer(jst, 2)["w"]))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_head_logits_matches_reference(softcap):
    rng = np.random.default_rng(6)
    h = (rng.standard_normal((3, 64)) * 4).astype(np.float32)
    table = rng.standard_normal((300, 64)).astype(np.float32)
    want = np.asarray(JC.head_logits(jnp.asarray(h), jnp.asarray(table),
                                     softcap))
    got = TC.head_logits(_t(h), _t(table), softcap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if softcap:
        assert float(got.abs().max()) < softcap < float(
            TC.head_logits(_t(h), _t(table)).abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [False, True])
def test_embed_scale_matches_reference(scale, dtype):
    """The sqrt(d) multiplier is rounded to the compute dtype before it
    multiplies (d=2304: 48.0 exactly; d=72: 8.485... rounds): bitwise."""
    for d in (2304, 72):
        table = np.random.default_rng(d).standard_normal((40, d)).astype(
            np.float32)
        toks = np.asarray([[0, 5, 39], [7, 7, 1]])
        want = JE.embed({"table": jnp.asarray(table)}, jnp.asarray(toks),
                        scale, jnp.dtype(dtype))
        got = TE.embed({"table": _t(table)}, _t(toks), scale,
                       getattr(torch, dtype))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


# -------------------------------------------------------------- attention

def _attn_cfgs(**kw):
    base = dict(d_model=72, n_heads=4, n_kv_heads=2, head_dim=16)
    base.update(kw)
    return JA.AttentionConfig(**base), TA.AttentionConfig(**base)


def _attn_params(seed, jcfg):
    """The reference's attention params with random biases and norm
    scales (it initialises both at zero)."""
    tree = jax.tree.map(np.asarray, JA.init_attention(
        jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for k in ("bq", "bk", "bv"):
        if k in tree:
            tree[k] = (rng.standard_normal(tree[k].shape) * 0.5).astype(
                np.float32)
    for k in ("q_norm", "k_norm"):
        if k in tree:
            tree[k]["scale"] = (rng.standard_normal(
                tree[k]["scale"].shape) * 0.5).astype(np.float32)
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: _t(a), tree))


@pytest.mark.parametrize("flags", [{}, {"qkv_bias": True},
                                   {"qk_norm": True},
                                   {"qkv_bias": True, "qk_norm": True}])
def test_project_qkv_matches_reference(flags):
    """Bias, then heads, then the per-head RMSNorm; attention width 64
    against d_model 72 (gemma2's shape: n_heads * head_dim != d)."""
    jcfg, tcfg = _attn_cfgs(**flags)
    jp, tp = _attn_params(0, jcfg)
    tinit = TA.init_attention(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) if torch.is_tensor(v) else
            {kk: tuple(vv.shape) for kk, vv in v.items()}
            for k, v in tinit.items()} == \
        {k: tuple(v.shape) if not isinstance(v, dict) else
         {kk: tuple(vv.shape) for kk, vv in v.items()} for k, v in jp.items()}
    x = np.random.default_rng(1).standard_normal((2, 5, 72)).astype(
        np.float32)
    want = JA._project_qkv(jp, jnp.asarray(x), jcfg)
    got = TA._project_qkv(tp, _t(x), tcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (50.0, 0), (0.0, 6),
                                            (50.0, 6), (5.0, 1)])
def test_attend_softcap_and_window_match_reference(softcap, window):
    """Prefill attention over 20 positions; the reference's flash scan in
    chunks of 4 against the port's one-pass softmax."""
    jcfg, tcfg = _attn_cfgs(softcap=softcap, window=window, qkv_bias=True)
    jp, tp = _attn_params(2, jcfg)
    x = np.random.default_rng(3).standard_normal((2, 20, 72)).astype(
        np.float32) * 3
    pos = np.arange(20)
    want, (jk, jv) = JA.attend(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                               q_chunk=4, kv_chunk=4, return_kv=True)
    got, (tk, tv) = TA.attend(tp, _t(x), tcfg, _t(pos), return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)


def _pool_case(rng, b, kvh, hd, bs, nbps):
    n = 2 + b * nbps
    table = (rng.permutation(n - 2) + 2).reshape(b, nbps).astype(np.int32)
    kp = rng.standard_normal((n, bs, kvh, hd)).astype(np.float32)
    vp = rng.standard_normal((n, bs, kvh, hd)).astype(np.float32)
    return table, kp, vp


WINDOW = 8
# lengths on both sides of the window: window - 1, window, window + 1 and
# far past it (the query sits at position ``length``)
LENGTHS = np.asarray([WINDOW - 1, WINDOW, WINDOW + 1, 21], np.int32)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_paged_decode_routes_at_the_window_edges(softcap):
    """One decode step of a softcapped, windowed attention layer against a
    paged pool at lengths 7, 8, 9 and 21 (window 8): the port's kernel
    route (``ref.paged_attention_ref``, ``len - t < window`` as the CUDA
    kernel's ``live_span``), its gather route and the reference's gather
    route.  The gather routes scale then divide as the reference does; the
    kernel route folds hd^-0.5 / softcap into one constant: all within
    1e-5 (seen: ~1e-7)."""
    jcfg, tcfg = _attn_cfgs(softcap=softcap, window=WINDOW, qk_norm=True)
    jp, tp = _attn_params(4, jcfg)
    rng = np.random.default_rng(5)
    bs, nbps = 4, 6
    table, kp, vp = _pool_case(rng, 4, 2, 16, bs, nbps)
    x = rng.standard_normal((4, 1, 72)).astype(np.float32)
    outs = {}
    for kernel in (True, False):
        cfg = dataclasses.replace(tcfg, paged_kernel=kernel)
        pool = {"k": _t(kp), "v": _t(vp)}
        outs[kernel], pool = TA.paged_decode_attend(tp, _t(x), cfg, pool,
                                                    _t(LENGTHS), _t(table))
    want, _ = JA.paged_decode_attend(
        jp, jnp.asarray(x), jcfg, {"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
        jnp.asarray(LENGTHS), jnp.asarray(table))
    np.testing.assert_allclose(outs[False].numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(outs[True].numpy(), outs[False].numpy(), **TOL)


@pytest.mark.parametrize("kernel", [True, False])
def test_window_drops_exactly_the_keys_out_of_reach(kernel):
    """With window 8, overwriting every key and value at a position
    ``<= length - 8`` leaves each slot's output bitwise unchanged; writing
    the one at ``length - 7`` changes it (the window holds 8 keys, the
    query's own included)."""
    _, tcfg = _attn_cfgs(softcap=50.0, window=WINDOW, paged_kernel=kernel)
    rng = np.random.default_rng(7)
    bs, nbps = 4, 6
    table, kp, vp = _pool_case(rng, 4, 2, 16, bs, nbps)
    q = _t(rng.standard_normal((4, 4, 16)).astype(np.float32))

    def run(kp_, vp_):
        if kernel:
            return ref.paged_attention_ref(q, _t(kp_), _t(vp_), _t(table),
                                           _t(LENGTHS), softcap=50.0,
                                           window=WINDOW)
        dense = TA.paged_gather_kv({"k": _t(kp_), "v": _t(vp_)}, _t(table))
        s_max = dense["k"].shape[1]
        kvp = torch.arange(s_max)
        cl = _t(LENGTHS).long()
        kvp = torch.where(kvp <= cl[:, None], kvp,
                          TA.q_pos_sentinel(s_max, cl)[:, None])
        o, l, _ = TA.decode_attend_partial(q[:, None], dense["k"],
                                           dense["v"], tcfg, kvp, cl)
        return (o / l[..., None]).reshape(4, 4, 16)

    base = run(kp, vp)

    def poke(pos_of_slot):
        kp2, vp2 = kp.copy(), vp.copy()
        for b, pos in enumerate(pos_of_slot):
            for p in pos:
                blk, off = table[b, p // bs], p % bs
                kp2[blk, off] = 100.0
                vp2[blk, off] = -100.0
        return run(kp2, vp2)

    out_of_reach = [range(0, max(0, int(n) - WINDOW + 1)) for n in LENGTHS]
    torch.testing.assert_close(poke(out_of_reach), base, rtol=0, atol=0)
    edge = poke([[int(n) - WINDOW + 1] for n in LENGTHS])
    assert bool((edge - base).abs().amax((1, 2)).gt(0).all())


def test_decode_attend_dense_cache_window_matches_reference():
    """The dense cache's decode at per-slot lengths 7, 8, 9 and 21 with a
    softcap and window 8, int8 and float32 caches: the port's within 1e-5
    of the reference (float32) and 5e-3 (int8: q and p rounded to bf16)."""
    jcfg, tcfg = _attn_cfgs(softcap=50.0, window=WINDOW, qkv_bias=True)
    jp, tp = _attn_params(8, jcfg)
    rng = np.random.default_rng(9)
    for dtype, atol in (("float32", 1e-5), ("int8", 5e-3)):
        k = rng.standard_normal((4, 24, 2, 16)).astype(np.float32)
        v = rng.standard_normal((4, 24, 2, 16)).astype(np.float32)
        x = rng.standard_normal((4, 1, 72)).astype(np.float32)
        jc = JA.init_kv_cache(4, 24, jcfg, jnp.dtype(dtype))
        jc = JA.update_kv_cache(jc, jnp.asarray(k), jnp.asarray(v), 0)
        tc = TA.init_kv_cache(4, 24, tcfg, getattr(torch, dtype))
        tc = TA.update_kv_cache(tc, _t(k), _t(v), 0)
        want, _ = JA.decode_attend(jp, jnp.asarray(x), jcfg, jc,
                                   jnp.asarray(LENGTHS))
        got, _ = TA.decode_attend(tp, _t(x), tcfg, tc, _t(LENGTHS))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol, err_msg=dtype)


# --------------------------------------------- kernel plans at new widths

@pytest.mark.parametrize("arch", ARCHS)
def test_mlp_and_predictor_plans_take_the_full_width(arch):
    """The decode MLP (B in 1, 4, 16), the chunk MLPs (S=64, float32 and
    bf16 x, float32 and int8 weights), the int8 decode MLP, the predictors
    (B=4 and S=64, and the counts kernel) and the sign pack at the arch's
    d and k with its capacity of 20% in groups of 8: every plan accepts
    the shape on an H100's figures."""
    cfg = get_config(arch)
    d, k, g = cfg.d_model, cfg.d_ff, cfg.sparse.group_size
    cap_rows = cfg.sparse.capacity(k) * g
    for b in (1, 4, 16):
        pl = KF.decode_plan(b, d, cap_rows, g, SMS, DECODE_H100)
        assert pl.smem_bytes <= 232448
        KF.decode_q_plan(b, d, cap_rows, g, 128, SMS, DECODE_Q_H100)
    for x_elem in (4, 2):
        KF.plan(64, d, cap_rows, x_elem, SMS, CHUNK_H100)
        KF.plan(64, d, cap_rows, x_elem, SMS, CHUNK_H100, w_elem=1,
                group_size=g)
    w = P.packed_width(d)
    for s in (4, 64):
        KP.margins_plan(s, w, k, g, _card(15))
    KP.margins_plan(4, w, k, 1, _card(15), counts=True)
    for rows, elem in ((k, 4), (4, 4), (4, 2)):
        KS.plan(rows, d, elem, 0)


# (B, max_len) of the chip phases: the archs phase's decode (B=4, 32
# positions), gemma2's window check (max_len 4608) and the serve (256)
ATTN_SHAPES = ((4, 32), (4, 4608), (4, 256), (16, 4608))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_attention_plan_takes_each_arch(arch):
    """paged_attention's plan at the arch's heads, kv heads and head dim
    (gemma2: 8 / 4 / 256; granite: MQA, rep 48), block 16, float32 and
    bf16 pools: within the shared memory limit and one cluster grid."""
    cfg = get_config(arch)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    for b, max_len in ATTN_SHAPES:
        for elem in (4, 2):
            pl = KA.plan(b, h, kvh, hd, 16, max_len // 16, elem, PAGED_H100)
            assert pl.smem_bytes <= KA.SMEM_LIMIT
            assert pl.clusters == b * kvh * -(-(h // kvh) // pl.rep_group)
