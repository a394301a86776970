"""int8 MLP weights in the port against the reference: ``core/quantize.py``
(leaves, scales and sign packs bitwise; the dequantized view within 1e-6),
the int8 kernels' plain versions against the reference's Pallas kernels in
interpret mode (telemetry exact, y within rtol=atol=1e-5: float32 sums of
the same products in another order, as tests/test_torch_kernels.py holds
the float32 kernel), the int8 sparse MLP end to end, and the bridge of a
quantized parameter tree.

Widths: d=64, k=128 (the reduced model's) and d=128, k=512, with quant
groups of qg=32 (qg must divide d and k and be a multiple of G=8).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as j_reduced
from repro.core import predictor as JP
from repro.core import quantize as JQ
from repro.core import selection as JS
from repro.core import sparse_mlp as JSM
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.core import quantize as TQ
from repro_torch.core import sparse_mlp as TSM
from repro_torch.kernels import ops as tops
from repro_torch.models import lm as tlm

G, QG = 8, 32
TOL = dict(rtol=1e-5, atol=1e-5)
DEAD = TSM.DEAD_SLOT_ALPHA


def _weights(seed: int, d: int, k: int, gated: bool = True):
    rng = np.random.default_rng(seed)
    names = ("wg_t", "wu_t", "wd_t") if gated else ("wg_t", "wd_t")
    w = {n: (rng.standard_normal((k, d)) * d ** -0.5).astype(np.float32)
         for n in names}
    w["wd_t"][:QG, :3] = 0.0      # an all-zero column group: scale 1
    w["wg_t"][5, :QG] = 0.0       # an all-zero row group
    return w


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("d,k,gated", [(64, 128, True), (128, 512, True),
                                       (128, 512, False)])
def test_quantize_mlp_node_bitwise(d, k, gated):
    w = _weights(0, d, k, gated)
    ref = JQ.quantize_mlp_node({n: jnp.asarray(v) for n, v in w.items()},
                               QG, G)
    port = TQ.quantize_mlp_node({n: _t(v) for n, v in w.items()}, QG, G)
    assert set(port) == set(ref)
    for name, v in ref.items():
        assert port[name].dtype == getattr(torch, str(v.dtype)), name
        np.testing.assert_array_equal(port[name].numpy(), np.asarray(v),
                                      err_msg=name)
    assert float(port["wd_s"][0, 0]) == 1.0
    dv_r, dv_p = JQ.dense_view(ref), TQ.dense_view(port)
    assert set(dv_p) == set(dv_r) and "wg_q" not in dv_p
    for name in ("wg_t", "wu_t", "wd_t"):
        if name in dv_r:
            np.testing.assert_allclose(dv_p[name].numpy(),
                                       np.asarray(dv_r[name]), rtol=0,
                                       atol=1e-6, err_msg=name)
    assert TQ.quant_group_size_of(port) == QG
    assert TQ.mlp_hidden_rows(port) == k == TQ.mlp_hidden_rows(dv_p)


@pytest.mark.parametrize("d,k,qg,ok", [(64, 128, 32, True),
                                       (64, 128, 12, False),   # d % qg
                                       (64, 96, 64, False),    # k % qg
                                       (60, 120, 30, False),   # qg % G
                                       (64, 128, 0, False)])   # qg < 1
def test_check_quant_dims_agrees_with_reference(d, k, qg, ok):
    for check in (JQ.check_quant_dims, TQ.check_quant_dims):
        if ok:
            check(d, k, G, qg)
        else:
            with pytest.raises(ValueError):
                check(d, k, G, qg)


def _selection(x, w, d, a):
    pw = JP.pack_signs(jnp.asarray(w["wg_t"]))
    gm, _ = jops.predict_group_margins(pw, jnp.asarray(x), d, jnp.asarray(a),
                                       group_size=G, interpret=True)
    cap = JSM.SparseInferConfig(capacity_frac=0.25,
                                group_size=G).capacity(w["wg_t"].shape[0])
    sel, _ = JS.capacity_select_with_stats(JS.union_margin(gm), cap)
    return gm, sel


@pytest.mark.parametrize("variant", ["gated", "ungated", "fatrelu",
                                     "short-count", "chunk"])
def test_fused_sparse_mlp_q_plain_matches_reference(variant):
    d, k = 128, 512
    b = 12 if variant == "chunk" else 4
    w = _weights(1, d, k, gated=variant != "ungated")
    x = np.random.default_rng(2).standard_normal((b, d)).astype(np.float32)
    a = np.linspace(0.9, 1.1, b).astype(np.float32)
    a[-1] = DEAD
    act = "fatrelu" if variant == "fatrelu" else "relu"
    thr = 0.05 if variant == "fatrelu" else 0.0
    gm, sel = _selection(x, w, d, a)
    count = sel.count // 2 if variant == "short-count" else sel.count
    qn = JQ.quantize_mlp_node({n: jnp.asarray(v) for n, v in w.items()},
                              QG, G)
    names = ("wg_q", "wg_s", "wu_q", "wu_s", "wd_q", "wd_s")
    jfn, tfn = ((jops.fused_sparse_mlp_chunk_q, tops.fused_sparse_mlp_chunk_q)
                if variant == "chunk" else
                (jops.fused_sparse_mlp_q, tops.fused_sparse_mlp_q))
    kw = dict(group_size=G, activation=act, fatrelu_threshold=thr,
              collect_stats=True)
    y_r, tel_r = jfn(jnp.asarray(x), *[qn.get(n) for n in names],
                     sel.indices, count, gm, interpret=True, **kw)
    y_p, tel_p = tfn(_t(x), *[_t(qn[n]) if n in qn else None for n in names],
                     _t(sel.indices), _t(count), _t(gm), **kw)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_array_equal(tel_p.numpy(), np.asarray(tel_r))
    kw["collect_stats"] = False
    y_only = tfn(_t(x), *[_t(qn[n]) if n in qn else None for n in names],
                 _t(sel.indices), _t(count), **kw)
    np.testing.assert_array_equal(y_only.numpy(), y_p.numpy())


def _cfgs(**kw):
    ref = JSM.SparseInferConfig(enabled=True, strategy="pallas",
                                activation="relu", group_size=G,
                                capacity_frac=0.25, weight_dtype="int8",
                                quant_group_size=QG, sparse_max_batch=4,
                                **kw)
    return ref, TSM.SparseInferConfig(**dataclasses.asdict(ref))


@pytest.mark.parametrize("b", [3, 10])
def test_int8_sparse_mlp_matches_reference(b):
    """Decode (b <= sparse_max_batch) and chunk (b > it) regimes of
    ``pallas_mlp`` over quantized params, plus the dense view: y within
    1e-5, stats exact."""
    ref_cfg, port_cfg = _cfgs()
    w = _weights(3, 64, 128)
    jp = JSM.prepare_sparse_params({n: jnp.asarray(v) for n, v in w.items()},
                                   ref_cfg)
    tp = TSM.prepare_sparse_params({n: _t(v) for n, v in w.items()},
                                   port_cfg)
    assert TQ.is_quantized(tp) and "wg_t" not in tp
    x = np.random.default_rng(b).standard_normal((b, 64)).astype(np.float32)
    a = np.full(b, 1.03, np.float32)
    a[0] = DEAD
    y_r, st_r = JSM.pallas_mlp(jp, jnp.asarray(x), ref_cfg,
                               alpha=jnp.asarray(a), interpret=True,
                               return_stats=True)
    y_p, st_p = TSM.pallas_mlp(tp, _t(x), port_cfg, alpha=_t(a),
                               return_stats=True)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
    for key in TSM.MLP_STAT_KEYS:
        np.testing.assert_array_equal(st_p[key].numpy(),
                                      np.asarray(st_r[key]), err_msg=key)
    y_r = JSM.dense_mlp(jp, jnp.asarray(x), ref_cfg)
    y_p = TSM.dense_mlp(tp, _t(x), port_cfg)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)


def test_bridge_carries_a_quantized_tree():
    """Quantize-then-bridge equals bridge-then-quantize, leaf for leaf and
    bitwise; and the port's prepare_sparse leaves bridged int8 nodes as
    they are."""
    jcfg = j_reduced("prosparse-llama2-7b")
    tcfg = t_reduced("prosparse-llama2-7b")
    sp = dict(weight_dtype="int8", quant_group_size=QG)
    jcfg = jcfg.replace(sparse=dataclasses.replace(jcfg.sparse, **sp))
    tcfg = tcfg.replace(sparse=dataclasses.replace(tcfg.sparse, **sp))
    jparams = jlm.init_lm(jax.random.PRNGKey(4), jcfg)
    q_then_b = bridge.params_from_numpy(
        jax.tree.map(np.asarray, jlm.prepare_sparse(jparams, jcfg.sparse)),
        tcfg, device="cpu")
    b_then_q = tlm.prepare_sparse(bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"), tcfg.sparse)
    again = tlm.prepare_sparse(q_then_b, tcfg.sparse)
    for i in range(tcfg.n_layers):
        mq, mb = q_then_b["blocks"][i]["mlp"], b_then_q["blocks"][i]["mlp"]
        assert set(mq) == set(mb) == {"sign_wg", *TQ.QUANT_KEYS}
        for name in mq:
            assert mq[name].dtype == mb[name].dtype, name
            assert torch.equal(mq[name], mb[name]), (i, name)
        assert again["blocks"][i]["mlp"] is mq
