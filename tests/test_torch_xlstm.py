"""The xlstm family through the port against the JAX package: xlstm-125m
at its ``reduced_config`` (one group of 4 blocks in the reference's order
mLSTM, sLSTM, mLSTM, mLSTM; d 64, 4 heads: mLSTM head width 32 =
d_inner / heads, sLSTM's 16), with the reference's weights carried over
by ``repro_torch.bridge``.  The family has no MLP: sparsity is off in its
config, no alphas are read and no stats are returned.

Every RMSNorm scale and conv bias gets a seeded random value on both
sides (0.3 N(0, 1)), and the gate biases a shift of 0.3 N(0, 1) (the
reference starts them at 0 and 3): a zero scale or bias would hide a
gate or a norm taken in the wrong order.  Token inputs and the cells'
inputs come from a seeded numpy generator.

Tolerances: logits within 1e-4; each cell's output and every state leaf
(c, n, m, the conv tail; sLSTM's h) within 1e-5 x the largest magnitude
of the reference's tensor; a server's tokens exactly.
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
from repro.configs.registry import reduced_config as j_reduced
from repro.layers import xlstm as jxl
from repro.models import lm as jlm
from repro.runtime import server as jserver
from repro_torch import bridge
from repro_torch.configs.base import ControllerConfig
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.layers import xlstm as txl
from repro_torch.models import lm as tlm
from repro_torch.runtime import server as tserver
from test_torch_encdec import _close, _requests
from test_torch_hybrid import STATE_TOL, _rel_close, _state_dict

ARCH = "xlstm-125m"
B, PLEN, STEPS, MAX_LEN = 2, 10, 4, 16


def _cfgs(sparse: bool = False):
    """(reference config, port config); ``sparse``: SparseInfer switched
    on (strategy pallas), which this family has nothing to apply to."""
    out = []
    for reduced in (j_reduced, t_reduced):
        cfg = reduced(ARCH)
        out.append(cfg.replace(sparse=dataclasses.replace(
            cfg.sparse, enabled=sparse, strategy="pallas")))
    return out


def _perturb(node, rng) -> None:
    for k, v in node.items():
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k in ("scale", "conv_b"):
            node[k] = (rng.standard_normal(v.shape) * 0.3).astype(v.dtype)
        elif k in ("b_if", "b"):
            node[k] = (v + rng.standard_normal(v.shape) * 0.3).astype(
                v.dtype)


@functools.lru_cache(maxsize=None)
def _ref_tree() -> dict:
    jcfg, _ = _cfgs()
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0),
                                                jcfg))
    _perturb(tree, np.random.default_rng(1))
    return tree


def _params(tcfg):
    tree = _ref_tree()
    return (jax.tree.map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, tcfg, device="cpu"))


def _xc():
    jcfg, _ = _cfgs()
    xc = jlm.xlstm_cfg(jcfg)
    return xc, txl.XLSTMConfig(**dataclasses.asdict(xc))


def _cell(kind: str, seed: int):
    """One cell's params (perturbed) on both sides."""
    xc, _ = _xc()
    init = jxl.init_mlstm if kind == "m" else jxl.init_slstm
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), xc))
    _perturb(tree, np.random.default_rng(seed))
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


def _check_state(got: dict, want, msg: str) -> None:
    want = _state_dict(want)
    assert set(got) == set(want), (set(got), set(want))
    for name, v in want.items():
        _rel_close(got[name], v, STATE_TOL, f"{msg} {name}")


CELLS = {"m": (jxl.mlstm_forward, jxl.mlstm_decode, txl.mlstm_forward,
               txl.mlstm_decode),
         "s": (jxl.slstm_forward, jxl.slstm_decode, txl.slstm_forward,
               txl.slstm_decode)}


@pytest.mark.parametrize("kind", ["m", "s"])
def test_cell_forward_and_decode_match_reference(kind):
    """A 7-token forward from a fresh state (the stabilizers at -1e30),
    then a 5-token forward from that state, then 3 decode steps: every
    output and state within ``STATE_TOL``."""
    xc, tc = _xc()
    jfwd, jdec, tfwd, tdec = CELLS[kind]
    jp, tp = _cell(kind, 3)
    x = np.random.default_rng(4).standard_normal(
        (B, 15, xc.d_model)).astype(np.float32)
    jy, jst = jfwd(jp, jnp.asarray(x[:, :7]), xc, return_state=True)
    ty, tst = tfwd(tp, torch.from_numpy(x[:, :7]), tc, return_state=True)
    _rel_close(ty, jy, STATE_TOL, "forward")
    _check_state(tst, jst, "forward")
    jy, jst = jfwd(jp, jnp.asarray(x[:, 7:12]), xc, jst, return_state=True)
    ty, tst = tfwd(tp, torch.from_numpy(x[:, 7:12]), tc, tst,
                   return_state=True)
    _rel_close(ty, jy, STATE_TOL, "forward from a state")
    _check_state(tst, jst, "forward from a state")
    for t in range(12, 15):
        jy, jst = jdec(jp, jnp.asarray(x[:, t:t + 1]), jst, xc)
        ty, tst = tdec(tp, torch.from_numpy(x[:, t:t + 1]), tst, tc)
        _rel_close(ty, jy, STATE_TOL, f"decode {t}")
        _check_state(tst, jst, f"decode {t}")


@pytest.mark.parametrize("kind", ["m", "s"])
def test_cell_decode_from_zeroed_state(kind):
    """Decode from an all-zero state (``m`` at 0, as ``init_caches``
    gives it): 3 steps within ``STATE_TOL``; its first step's stabilizer
    is not the one from a fresh state (m at -1e30)."""
    xc, tc = _xc()
    _, jdec, _, tdec = CELLS[kind]
    jp, tp = _cell(kind, 6)
    fresh = (jxl.init_mlstm_state(B, xc, jnp.float32) if kind == "m"
             else jxl.init_slstm_state(B, xc))
    jst = jax.tree.map(jnp.zeros_like, fresh)
    tst = {k: torch.zeros(np.shape(v), dtype=getattr(
        torch, np.asarray(v).dtype.name)) for k, v in
        _state_dict(fresh).items()}
    tst_fresh = (txl.init_mlstm_state(B, tc, torch.float32) if kind == "m"
                 else txl.init_slstm_state(B, tc))
    assert float(tst_fresh["m"].max()) == float(np.float32(-1e30))
    x = np.random.default_rng(8).standard_normal(
        (B, 3, xc.d_model)).astype(np.float32)
    _, st_fresh = tdec(tp, torch.from_numpy(x[:, :1]), tst_fresh, tc)
    for t in range(3):
        jy, jst = jdec(jp, jnp.asarray(x[:, t:t + 1]), jst, xc)
        ty, tst = tdec(tp, torch.from_numpy(x[:, t:t + 1]), tst, tc)
        _rel_close(ty, jy, STATE_TOL, f"decode {t}")
        _check_state(tst, jst, f"decode {t}")
        if t == 0:
            assert not torch.equal(tst["m"], st_fresh["m"])


def test_slstm_recurrent_gate_layout():
    """The block-diagonal recurrence: head j's (4, hd) outputs land at
    gate g's columns g * d + j * hd.  With h on head 1's channels alone
    and the input term cancelling the bias, the new cell state is
    tanh(the z gate's recurrent term): non-zero on head 1's channels
    alone."""
    _, tc = _xc()
    _, tp = _cell("s", 2)
    hd = tc.s_head_dim
    st = txl.init_slstm_state(1, tc)
    st["h"][0, hd:2 * hd] = 1.0
    new = txl._slstm_step(tp, tc, st, -tp["b"][None].float())
    moved = (new["c"][0].abs() > 0).nonzero()[:, 0]
    assert moved.tolist() == list(range(hd, 2 * hd))


def test_layout_init_and_bridge():
    """The bridge's lists: 3 mLSTM and 1 sLSTM block; ``init_lm`` builds
    the same layout; the order of the blocks is the reference's; a depth
    the tree does not hold raises."""
    _, tcfg = _cfgs()
    tree = _ref_tree()
    tp = bridge.params_from_numpy(tree, tcfg, device="cpu")
    assert [len(tp["mlstm"]), len(tp["slstm"])] == [3, 1]
    assert list(tlm._xlstm_blocks(tcfg)) == [("m", 0), ("s", 0), ("m", 1),
                                             ("m", 2)]
    np.testing.assert_array_equal(tp["mlstm"][2]["cell"]["b_if"].numpy(),
                                  tree["mlstm"]["cell"]["b_if"][2])
    init = tlm.init_lm(tcfg, device="cpu")
    assert set(init) == set(tp) == {"embed", "final_norm", "mlstm",
                                    "slstm"}
    assert tlm.has_sparse_mlp(tcfg) is False
    with pytest.raises(ValueError, match="mlstm"):
        bridge.params_from_numpy(tree, tcfg.replace(n_layers=8),
                                 device="cpu")
    with pytest.raises(ValueError, match="slstm_every"):
        tlm.init_lm(tcfg.replace(n_layers=6), device="cpu")


def test_init_caches_match_reference():
    """``init_caches``: every leaf's shape and dtype the reference's,
    every leaf zero, the stabilizers ``m`` too."""
    jcfg, tcfg = (c.replace(dtype="bfloat16") for c in _cfgs())
    jc = jlm.init_caches(jcfg, 3, MAX_LEN)
    tc = tlm.init_caches(tcfg, 3, MAX_LEN, device="cpu")
    assert set(tc) == {"mlstm", "slstm"}
    for part, lead in (("mlstm", 2), ("slstm", 1)):
        leaves = {k: np.asarray(v) for k, v in _state_dict(jc[part]).items()}
        n = int(np.prod(next(iter(leaves.values())).shape[:lead]))
        assert len(tc[part]) == n
        for layer in tc[part]:
            assert set(layer) == set(leaves)
            for name, v in leaves.items():
                assert tuple(layer[name].shape) == v.shape[lead:]
                assert layer[name].dtype == getattr(torch, v.dtype.name)
                assert not bool(layer[name].any())


def _port_caches(jc: dict) -> dict:
    """The reference's xlstm caches in the port's layout."""
    out = {}
    for part, lead in (("mlstm", 2), ("slstm", 1)):
        leaves = {k: np.asarray(v) for k, v in _state_dict(jc[part]).items()}
        n = int(np.prod(next(iter(leaves.values())).shape[:lead]))
        flat = {k: v.reshape((n,) + v.shape[lead:])
                for k, v in leaves.items()}
        out[part] = [{k: v[i] for k, v in flat.items()} for i in range(n)]
    return out


def _check_caches(tc: dict, jc: dict, msg: str) -> None:
    want = _port_caches(jc)
    for part in want:
        assert len(tc[part]) == len(want[part])
        for i, (got, ref) in enumerate(zip(tc[part], want[part])):
            _check_state(got, ref, f"{msg}: {part}[{i}]")


@pytest.mark.parametrize("start", ["prefill", "init_caches"])
@pytest.mark.parametrize("sparse", [False, True])
def test_decode_teacher_forced(start, sparse):
    """From a 10-token prefill (logits within 1e-4, the states within
    ``STATE_TOL``) or from ``init_caches`` (zeroed stabilizers), 4
    teacher-forced decode steps with ``collect_stats``: logits within
    1e-4, no stats on either side, every state within ``STATE_TOL``.
    SparseInfer on or off changes nothing: there is no MLP."""
    jcfg, tcfg = _cfgs(sparse)
    jp, tp = _params(tcfg)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, jcfg.vocab, size=(B, PLEN))
    forced = rng.integers(0, jcfg.vocab, size=(STEPS, B, 1))
    if start == "prefill":
        jl, jc = jax.jit(functools.partial(jlm.prefill, cfg=jcfg,
                                           max_len=MAX_LEN))(
            jp, tokens=jnp.asarray(prompt))
        with torch.inference_mode():
            tl, tc = tlm.prefill(tp, tcfg, torch.from_numpy(prompt),
                                 MAX_LEN)
        _close(tl, jl, 1e-4, "prefill")
        _check_caches(tc, jc, "prefill")
        plen = PLEN
    else:
        jc = jlm.init_caches(jcfg, B, MAX_LEN)
        tc = tlm.init_caches(tcfg, B, MAX_LEN, device="cpu")
        plen = 0
    jstep = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg,
                                      collect_stats=True))
    for t in range(STEPS):
        lens = np.full(B, plen + t, np.int32)
        jl, jc, jst = jstep(jp, token=jnp.asarray(forced[t]), caches=jc,
                            cache_len=jnp.asarray(lens))
        with torch.inference_mode():
            tl, tc, tst = tlm.decode_step(
                tp, tcfg, torch.from_numpy(forced[t]), tc,
                torch.from_numpy(lens), collect_stats=True)
        _close(tl, jl, 1e-4, f"step {t}")
        assert jst is None and tst is None
    _check_caches(tc, jc, "after decode")


def test_chunked_prefill_and_paged_kv_refused():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(tcfg)
    with pytest.raises(NotImplementedError):
        jlm.init_kv_pool(jcfg, 4, 8)
    with pytest.raises(NotImplementedError):
        tlm.init_kv_pool(tcfg, 4, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        tlm.prefill_chunk(tp, tcfg, torch.zeros((1, 8), dtype=torch.long),
                          tlm.init_caches(tcfg, 1, 16, device="cpu"), 0, 8)


# ---------------------------------------------------------------- servers --

def _servers(chunk: int = 0, sparse: bool = False):
    jcfg, tcfg = _cfgs(sparse)
    jp, tp = _params(tcfg)
    kw = dict(batch=2, max_len=32, prefill_chunk=chunk)
    return (jserver.Server(jlm, jcfg, jserver.ServeConfig(**kw), jp),
            tserver.Server(tlm, tcfg, tserver.ServeConfig(**kw), tp,
                           device="cpu"))


@pytest.mark.parametrize("chunk", [0, 8])
def test_serve_matches_reference(chunk):
    """5 mixed-tier requests over 2 slots (slots refill, splicing every
    state): every request's tokens equal.  ``prefill_chunk=8``: both
    servers warn that the family has no chunked prefill and admit through
    the monolithic prefill."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        jsrv, tsrv = _servers(chunk)
        vocab = tsrv.cfg.vocab
        jdone = jsrv.serve(_requests(3, 5, vocab, jserver.Request))
        tdone = tsrv.serve(_requests(3, 5, vocab, tserver.Request))
    for jr, tr in zip(sorted(jdone, key=lambda r: r.uid),
                      sorted(tdone, key=lambda r: r.uid)):
        assert tr.outcome == jr.outcome == "completed"
        np.testing.assert_array_equal(tr.out, jr.out, err_msg=f"uid {tr.uid}")
    warned = [w for w in rec if "has no chunked prefill" in str(w.message)]
    assert len(warned) == (2 if chunk else 0)
    assert tsrv.prefill_chunks_run == 0


def test_generate_matches_reference():
    jsrv, tsrv = _servers()
    prompts = np.random.default_rng(4).integers(
        0, tsrv.cfg.vocab, size=(2, 9)).astype(np.int32)
    np.testing.assert_array_equal(tsrv.generate(prompts, 6),
                                  np.asarray(jsrv.generate(prompts, 6)))


def test_controller_with_sparsity_refused():
    """The controller with sparsity on: both servers raise the
    reference's ValueError; with sparsity off it is inert on both."""
    jcfg, tcfg = _cfgs(True)
    jp, tp = _params(tcfg)
    for srv, sc, cc, cfg, p, kw in (
            (jserver.Server, jserver.ServeConfig, JControllerConfig, jcfg,
             jp, {}),
            (tserver.Server, tserver.ServeConfig, ControllerConfig, tcfg,
             tp, {"device": "cpu"})):
        with pytest.raises(ValueError, match="controller unsupported"):
            srv(jlm if srv is jserver.Server else tlm, cfg, sc(
                batch=2, max_len=32, controller=cc(enabled=True)), p, **kw)
    _, tcfg = _cfgs(False)
    srv = tserver.Server(tlm, tcfg, tserver.ServeConfig(
        batch=2, max_len=32, controller=ControllerConfig(enabled=True)), tp,
        device="cpu")
    assert srv.controller is None


def test_cache_helpers_walk_the_xlstm_tree():
    """``_splice_slot`` copies a finished prefill's states into its slot
    in both lists (a float32 conv tail into a bf16 cache) and nothing
    else."""
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
    tserver._splice_slot(full, one, 2)
    assert full["mlstm"][0]["conv"].dtype == torch.bfloat16
    for part in full:
        for f, o, b in zip(full[part], one[part], before[part]):
            for name, buf in f.items():
                assert torch.equal(buf[2:3], o[name].to(buf.dtype))
                assert torch.equal(buf[:2], b[name][:2])


def test_serve_cli_runs():
    """The serve CLI at reduced dims on the CPU: every request completes
    and nothing launches a kernel; ``--controller`` with sparsity on
    raises the reference's error."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    ops.reset_launch_counts()
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
            "3", "--batch", "2", "--max-new", "4"]
    rep = serve_cli.main(base)
    assert rep["completed"] == 3 and rep["tokens"] == 12
    assert rep["sparse"]["enabled"] is False
    assert sum(ops.launch_counts().values()) == 0
    with pytest.raises(ValueError, match="controller unsupported"):
        serve_cli.main(base + ["--strategy", "gather", "--controller"])


def test_entry_points_default_to_the_card():
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
