"""The training path's pieces through the port against the JAX package:
the synthetic data pipeline (``data/pipeline.py``), AdamW and its cosine
schedule (``optim/adamw.py``), int8 gradient compression with error
feedback (``optim/compress.py``), ``models/common.chunked_xent`` and
``layers/scan_utils.checkpointed_scan``.

Tolerances: batches, int8 codes and the scan's forward values exactly;
the schedule within 1e-6 relative; one AdamW update's params within 1e-6
relative and its moments within 1e-7 absolute; compression scales and
residuals within 1e-7 absolute; the loss and its gradients within 1e-6.

The AdamW tree holds leaves that the reference stacks along a layer axis
(the port's per-layer ``blocks`` list) and leaves it does not
(``final_norm``), in float32 and bfloat16: a block's norm scale is (L, d)
in the reference and decayed, (d,) in the port and decayed all the same,
while ``final_norm``'s (d,) scale is not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jdata
from repro.layers.scan_utils import checkpointed_scan as j_ckpt_scan
from repro.models import common as jcommon
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.data import pipeline as tdata
from repro_torch.layers import mamba2 as tm2
from repro_torch.layers import scan_utils as tscan
from repro_torch.layers import xlstm as txl
from repro_torch.models import common as tcommon
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.tree import flatten, reference_groups, reference_ndim

L = 3                                   # layers of the AdamW tree


# ------------------------------------------------------------------ data --

@pytest.mark.parametrize("seed,n_hosts,host_id", [(0, 1, 0), (7, 2, 1),
                                                  (3, 4, 2)])
def test_batches_equal_reference(seed, n_hosts, host_id):
    kw = dict(vocab=512, seq_len=33, global_batch=8, seed=seed,
              n_hosts=n_hosts, host_id=host_id)
    j_it = jdata.DataIterator(jdata.DataConfig(**kw))
    t_it = tdata.DataIterator(tdata.DataConfig(**kw))
    for _ in range(3):
        jb, tb = next(j_it), next(t_it)
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int64
            np.testing.assert_array_equal(tb[k].numpy(), jb[k])
    j_it.skip_to(11)
    t_it.skip_to(11)
    jb, tb = next(j_it), next(t_it)
    np.testing.assert_array_equal(tb["tokens"].numpy(), jb["tokens"])
    assert t_it.step == 12


def test_host_shards_disjoint_and_int64_default():
    kw = dict(vocab=256, seq_len=16, global_batch=4, n_hosts=2)
    a = tdata.SyntheticSource(tdata.DataConfig(host_id=0, **kw)).batch_at(5)
    b = tdata.SyntheticSource(tdata.DataConfig(host_id=1, **kw)).batch_at(5)
    assert a["tokens"].shape == (2, 16)
    assert not np.array_equal(a["tokens"], b["tokens"])
    batch = next(tdata.DataIterator(tdata.DataConfig(**kw)))
    assert batch["tokens"].dtype == torch.int64


# ----------------------------------------------------------------- adamw --

OPT = dict(lr_peak=1e-3, lr_min=1e-4, warmup_steps=10, decay_steps=50)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 30, 50, 80])
def test_cosine_lr(step):
    want = float(jadamw.cosine_lr(jadamw.AdamWConfig(**OPT),
                                  jnp.int32(step)))
    got = float(tadamw.cosine_lr(tadamw.AdamWConfig(**OPT), step))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _ref_tree(rng, scale: float = 1.0) -> dict:
    """A reference-layout tree: stacked (L, ...) block leaves, unstacked
    leaves, float32 and bfloat16."""
    def f(*shape, dt=np.float32):
        return (rng.standard_normal(shape) * scale).astype(dt)
    return {
        "blocks": {"w": f(L, 8, 4), "scale": f(L, 6),
                   "w16": f(L, 4, 4).astype(jnp.bfloat16)},
        "final_norm": {"scale": f(6)},
        "embed": {"table": f(10, 6).astype(jnp.bfloat16)},
        "gate": f(),
    }


def _port_tree(tree: dict) -> dict:
    """The reference layout -> the port's: one dict a layer in ``blocks``;
    bfloat16 leaves through float32 (exactly)."""
    def t(a):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    out = {k: (t(v) if not isinstance(v, dict) else
               {kk: t(vv) for kk, vv in v.items()})
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [{k: t(np.asarray(v)[i]) for k, v in tree["blocks"]
                      .items()} for i in range(L)]
    return out


def _back(tree: dict) -> dict:
    """The port's tree -> the reference layout, float32 numpy leaves."""
    def n(x):
        return x.detach().float().numpy()
    out = {k: (n(v) if not isinstance(v, dict) else
               {kk: n(vv) for kk, vv in v.items()})
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = {k: np.stack([n(b[k]) for b in tree["blocks"]])
                     for k in tree["blocks"][0]}
    return out


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("clip_binds", [False, True])
@pytest.mark.parametrize("step", [0, 4])
def test_adamw_update_matches_reference(clip_binds, step):
    rng = np.random.default_rng(10 * step + clip_binds)
    params = _ref_tree(rng)
    grads = _ref_tree(rng, scale=3.0 if clip_binds else 0.01)
    mu = jax.tree.map(lambda a: np.asarray(a, np.float32) * 0.1 * step,
                      _ref_tree(rng))
    nu = jax.tree.map(lambda a: np.square(np.asarray(a, np.float32)) * 0.01
                      * step, _ref_tree(rng))
    cfg_kw = dict(OPT, weight_decay=0.3, clip_norm=1.0)
    jp, jst, jm = jadamw.adamw_update(
        jadamw.AdamWConfig(**cfg_kw), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads),
        jadamw.AdamWState(jnp.int32(step), jax.tree.map(jnp.asarray, mu),
                          jax.tree.map(jnp.asarray, nu)))
    tp = _port_tree(params)
    tst = tadamw.AdamWState(step, _port_tree(mu), _port_tree(nu))
    tp, tst, tm = tadamw.adamw_update(tadamw.AdamWConfig(**cfg_kw), tp,
                                      _port_tree(grads), tst)
    assert tst.step == step + 1
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    assert (float(tm["grad_norm"]) > 1.0) == clip_binds
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for got, want in ((_back(tp), _f32(jp)),):
        jax.tree.map(lambda g, w: np.testing.assert_allclose(
            g, w, rtol=1e-6, atol=1e-7), got, want)
    for got, want in ((_back(tst.mu), _f32(jst.mu)),
                      (_back(tst.nu), _f32(jst.nu))):
        jax.tree.map(lambda g, w: np.testing.assert_allclose(
            g, w, rtol=0, atol=1e-7), got, want)
    for (path, leaf) in flatten(tp):
        want_dt = torch.bfloat16 if path[-1] in ("w16", "table") \
            else torch.float32
        assert leaf.dtype == want_dt, path


def test_decay_follows_the_reference_rank():
    """A block's (d,) norm scale is decayed (the reference's is (L, d)),
    ``final_norm``'s is not; a scalar is not."""
    tree = _port_tree(_ref_tree(np.random.default_rng(0)))
    mask = {p: reference_ndim(p, leaf) >= 2 for p, leaf in flatten(tree)}
    assert mask[("blocks", 0, "scale")] and mask[("blocks", 2, "w")]
    assert not mask[("final_norm", "scale")] and not mask[("gate",)]
    assert mask[("embed", "table")]
    # the decayed block scale moves by the decay term: with zero gradient
    # and weight decay wd the step is -lr * wd * p exactly as the
    # reference computes it
    zeros = jax.tree.map(lambda a: np.zeros_like(a, np.float32),
                         _ref_tree(np.random.default_rng(0)))
    cfg = tadamw.AdamWConfig(**OPT, weight_decay=0.5)
    p0 = _back(tree)
    tp, _, _ = tadamw.adamw_update(cfg, tree, _port_tree(zeros),
                                   tadamw.init_adamw(tree))
    got = _back(tp)
    jp, _, _ = jadamw.adamw_update(
        jadamw.AdamWConfig(**OPT, weight_decay=0.5),
        jax.tree.map(jnp.asarray, _ref_tree(np.random.default_rng(0))),
        jax.tree.map(jnp.asarray, zeros),
        jadamw.init_adamw(_ref_tree(np.random.default_rng(0))))
    assert not np.array_equal(got["blocks"]["scale"], p0["blocks"]["scale"])
    np.testing.assert_array_equal(got["final_norm"]["scale"],
                                  p0["final_norm"]["scale"])
    np.testing.assert_allclose(got["blocks"]["scale"],
                               np.asarray(jp["blocks"]["scale"]),
                               rtol=1e-6)


def test_global_norm_and_init():
    tree = _port_tree(_ref_tree(np.random.default_rng(2)))
    jt = _ref_tree(np.random.default_rng(2))
    np.testing.assert_allclose(float(tadamw.global_norm(tree)),
                               float(jadamw.global_norm(jt)), rtol=1e-6)
    st = tadamw.init_adamw(tree)
    assert st.step == 0
    for _, m in flatten(st.mu):
        assert m.dtype == torch.float32 and not m.any()


# -------------------------------------------------------------- compress --

@pytest.mark.parametrize("rounds", [1, 3])
def test_compress_grads_matches_reference(rounds):
    """The int8 codes equal the reference's, the scale is one per stacked
    leaf (the port's layers of ``blocks`` share it), and the residuals
    carry over rounds."""
    tree = _ref_tree(np.random.default_rng(0))
    j_ef = jcompress.init_ef(tree)
    t_ef = tcompress.init_ef(_port_tree(tree))
    for r in range(rounds):
        g = _ref_tree(np.random.default_rng(100 + r),
                      scale=10.0 ** (r - 1))
        g["final_norm"]["scale"] *= 1e-3
        jq, j_ef = jcompress.compress_grads(g, j_ef)
        tq, t_ef = tcompress.compress_grads(_port_tree(g), t_ef)
        codes = _back(jax.tree.map(lambda qs: qs[0], tq,
                                   is_leaf=lambda x: isinstance(x, tuple)))
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            a, np.asarray(b, np.float32)), codes,
            jax.tree.map(lambda qs: qs[0], jq,
                         is_leaf=lambda x: isinstance(x, tuple)))
        for layer in tq["blocks"]:
            for name, (q, sc) in layer.items():
                assert q.dtype == torch.int8
                np.testing.assert_allclose(
                    float(sc), float(jq["blocks"][name][1]), rtol=1e-7,
                    atol=0, err_msg=name)
        np.testing.assert_allclose(float(tq["final_norm"]["scale"][1]),
                                   float(jq["final_norm"]["scale"][1]),
                                   rtol=1e-7, atol=0)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=0, atol=1e-7), _back(t_ef.residual),
            _f32(j_ef.residual))
    deq_t = _back(tcompress.decompress_grads(tq))
    deq_j = _f32(jcompress.decompress_grads(jq))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=1e-7, atol=1e-9), deq_t, deq_j)


def test_quantize_round_half_to_even_and_error():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 127.0])
    q, s = tcompress.quantize_int8(x)
    jq, js = jcompress.quantize_int8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    g = {"w": torch.randn(50, generator=torch.Generator().manual_seed(0))}
    ef0 = tcompress.init_ef(g)
    _, ef1 = tcompress.compress_grads(g, ef0)
    err = float(tcompress.compression_error(g, ef0, ef1))
    jerr = float(jcompress.compression_error(
        {"w": jnp.asarray(g["w"].numpy())}, jcompress.init_ef(
            {"w": g["w"].numpy()}),
        jcompress.EFState({"w": jnp.asarray(ef1.residual["w"].numpy())})))
    assert 0 < err < 0.05
    np.testing.assert_allclose(err, jerr, rtol=1e-6)


# ----------------------------------------------------------------- xent ---

@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("s,chunk", [(12, 5), (12, 12), (7, 100)])
def test_chunked_xent_matches_reference(softcap, s, chunk):
    rng = np.random.default_rng(s + chunk)
    b, d, v = 2, 16, 40
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    table = (rng.standard_normal((v, d)) * 0.5).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, -1] = -100

    def jloss(h, t):
        return jcommon.chunked_xent(h, jnp.asarray(labels), t, softcap,
                                    chunk)
    jl, (jgh, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(table))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    tl = tcommon.chunked_xent(th, torch.from_numpy(labels).long(), tt,
                              softcap, chunk)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgt), atol=1e-6)


def test_chunked_xent_all_ignored_is_zero():
    h = torch.randn(1, 4, 8)
    y = torch.full((1, 4), -100)
    assert float(tcommon.chunked_xent(h, y, torch.randn(10, 8), 0.0, 2)) \
        == 0.0


# ------------------------------------------------------------------ scan --

@pytest.mark.parametrize("t,chunk", [(16, 0), (37, 0), (12, 5), (1, 0)])
def test_chunk_size_rule(t, chunk):
    """The boundary interval as the reference picks it (floor sqrt(T),
    shrunk to a divisor)."""
    want = chunk if chunk > 0 else max(1, int(np.sqrt(t)))
    want = min(want, t)
    while t % want:
        want -= 1
    assert tscan.chunk_size(t, chunk) == want


def _rnn_step(w):
    def step(carry, x):
        h, c = carry
        h = torch.tanh(h @ w + x[0]) * torch.sigmoid(x[1])
        return (h, c + h.sum()), (h * 2, h.square())
    return step


@pytest.mark.parametrize("t,chunk", [(16, 0), (15, 4), (9, 0)])
def test_checkpointed_scan_bitwise_and_grads(t, chunk):
    g = torch.Generator().manual_seed(t)
    w0 = torch.randn(6, 6, generator=g) * 0.4
    xs0 = (torch.randn(t, 3, 6, generator=g),
           torch.randn(t, 3, 6, generator=g))
    h0 = torch.randn(3, 6, generator=g)

    def run(scan):
        w = w0.clone().requires_grad_(True)
        xs = tuple(x.clone().requires_grad_(True) for x in xs0)
        (h, c), (ya, yb) = scan(_rnn_step(w), (h0, torch.zeros(())), xs)
        loss = h.sum() + c + (ya * yb).sum()
        loss.backward()
        return (h, c, ya, yb), (w.grad, *(x.grad for x in xs))

    out_c, grads_c = run(lambda s, c, x: tscan.checkpointed_scan(
        s, c, x, chunk))
    out_p, grads_p = run(tscan.scan)
    for a, b in zip(out_c, out_p):
        assert torch.equal(a, b)
    for a, b in zip(grads_c, grads_p):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    with torch.no_grad():
        out_n = tscan.checkpointed_scan(_rnn_step(w0), (h0, torch.zeros(())),
                                        xs0, chunk)
    assert torch.equal(out_n[0][0], out_p[0])


def test_checkpointed_scan_matches_reference():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((5, 5)) * 0.5).astype(np.float32)
    xs = rng.standard_normal((16, 2, 5)).astype(np.float32)

    def jstep(h, x):
        h = jnp.tanh(h @ w + x)
        return h, h * 3

    def tstep(h, x):
        h = torch.tanh(h @ torch.from_numpy(w) + x)
        return h, h * 3
    jh, jys = j_ckpt_scan(jstep, jnp.zeros((2, 5)), jnp.asarray(xs))
    th, tys = tscan.checkpointed_scan(tstep, torch.zeros(2, 5),
                                      torch.from_numpy(xs))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), atol=1e-6)


def _recurrent_cases():
    mc = tm2.Mamba2Config(d_model=32, d_state=8, head_dim=8, chunk=4)
    xc = txl.XLSTMConfig(d_model=32, n_heads=4)
    g = torch.Generator().manual_seed(0)
    return [("mamba2", tm2.mamba2_forward, tm2.init_mamba2(g, mc), mc),
            ("mlstm", txl.mlstm_forward, txl.init_mlstm(g, xc), xc),
            ("slstm", txl.slstm_forward, txl.init_slstm(g, xc), xc)]


@pytest.mark.parametrize("idx", [0, 1, 2], ids=["mamba2", "mlstm", "slstm"])
def test_recurrent_layers_train_forward_bitwise(idx):
    """The training forward (autograd on: sqrt-BPTT checkpoints) gives the
    serving forward's values bit for bit, and gradients reach every
    weight."""
    name, fwd, params, cfg = _recurrent_cases()[idx]
    x = torch.randn(2, 24, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        plain = fwd(params, x, cfg)
    leaves = [p for _, p in flatten(params)]
    for p in leaves:
        p.requires_grad_(True)
    out = fwd(params, x, cfg)
    assert torch.equal(out.detach(), plain), name
    grads = torch.autograd.grad(out.square().sum(), leaves,
                                allow_unused=True, materialize_grads=True)
    assert all(torch.isfinite(gr).all() for gr in grads)
    assert sum(int(gr.abs().sum() > 0) for gr in grads) >= len(grads) - 1


def test_reference_groups_follow_the_stacked_leaves():
    """The layers of a per-layer list share the key of the reference's
    stacked leaf; a moe config's dense first layers (an "mlp" node) stack
    apart from its MoE layers, as ``first_blocks`` and ``blocks``."""
    z = torch.zeros(2)
    tree = {"blocks": [{"ln": z, "mlp": {"w": z}},
                       {"ln": z, "moe": {"w": z}},
                       {"ln": z, "moe": {"w": z}}],
            "final_norm": {"scale": z},
            "mlstm": [{"cell": {"w": z}}, {"cell": {"w": z}}]}
    keys = dict(zip((p for p, _ in flatten(tree)), reference_groups(tree)))
    assert keys[("blocks", 1, "ln")] == keys[("blocks", 2, "ln")]
    assert keys[("blocks", 0, "ln")] != keys[("blocks", 1, "ln")]
    assert keys[("mlstm", 0, "cell", "w")] == keys[("mlstm", 1, "cell", "w")]
    assert keys[("final_norm", "scale")] == ("final_norm", "scale")
    assert len(set(keys.values())) == 6
