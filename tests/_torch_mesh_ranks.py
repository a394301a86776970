"""Rank bodies of the mesh tests (``tests/test_torch_mesh_*.py``): each runs
on every spawned rank of ``repro_torch.launch.ranks.run_ranks`` and imports
only torch, numpy and ``repro_torch`` (a spawned rank never imports JAX).
Each returns numpy values the test process holds against its own."""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from repro_torch.core import sparse_mlp as TSM
from repro_torch.layers import attention as A
from repro_torch.layers.mlp import mlp_apply
from repro_torch.models import lm as tlm
from repro_torch.runtime.server import Request, Server
from repro_torch.sharding import rules as R
from repro_torch.sharding import sparse as TSS


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return tree


@contextlib.contextmanager
def line_axes(axes: list):
    """Every gather over a line of ranks (``rules.gather_line``) inside
    the block appends the axis it crosses to ``axes``."""
    orig = R.gather_line

    def tapped(t, axis="model", mesh=None):
        axes.append(axis)
        return orig(t, axis, mesh)
    R.gather_line = tapped
    try:
        yield
    finally:
        R.gather_line = orig


def apply_cases(mesh, device, cases: list) -> list:
    """``core.sparse_mlp.apply`` under the mesh for each case: (params
    (numpy, whole), x, alpha, port config, return_stats); an x of (B, S, d)
    goes through ``mlp_apply`` as a prefill's rows (the sharded config's
    dense MLP, every row on every rank).  A decode's (B, d) x and per-slot
    alphas give the rank its 'data' line's slots (``rules.slot_range``).
    The rank places the params itself; per case it returns y and the
    stats (or None) of every slot, gathered over 'data' here, the axes
    the call itself gathered over and the rows of the gate leaf it
    kept."""
    out = []
    for params, x, alpha, cfg, stats in cases:
        whole = {k: torch.from_numpy(v) for k, v in params.items()}
        mine = TSS.place_serve_params(whole, mesh)
        axes: list = []
        with torch.inference_mode(), R.use_mesh(mesh):
            if x.ndim == 3:             # a prefill's rows: the dense MLP
                with line_axes(axes):
                    got = mlp_apply(mine, torch.from_numpy(x), cfg,
                                    prefill=True, return_stats=stats)
            else:
                rows = list(R.slot_range(x.shape[0], mesh))
                a = np.asarray(alpha)
                with line_axes(axes):
                    got = TSM.apply(mine, torch.from_numpy(x[rows]), cfg,
                                    alpha=torch.from_numpy(
                                        a[rows] if a.ndim else a),
                                    return_stats=stats)
                if stats:
                    got = (R.gather_slots(got[0], mesh),
                           {k: R.gather_slots(v, mesh)
                            for k, v in got[1].items()})
                else:
                    got = R.gather_slots(got, mesh)
        y, st = _np(got) if stats else (_np(got), None)
        out.append({"y": y, "stats": st, "axes": sorted(set(axes)),
                    "rows": mine.get("wg_t", mine.get("wg_q")).shape[0]})
    return out


def _requests(spec: list) -> list:
    return [Request(uid=u, prompt=np.asarray(p), max_new=m, sla=s)
            for u, p, m, s in spec]


def _state(srv: Server, done: list) -> dict:
    st = {"tokens": {r.uid: np.asarray(r.out) for r in done},
          "outcomes": {r.uid: r.outcome for r in done},
          "decode_steps": srv.decode_steps,
          "paged_stats": srv.paged_stats()}
    ctl = srv.controller
    if ctl is None:
        return st
    st["bucket_history"] = list(srv.bucket_history)
    st["active_cap"] = srv._active_cap
    for name in ("alphas", "density_ema", "fn_ema", "union_ema",
                 "predicted_ema"):
        st[name] = np.array(getattr(ctl.state, name))
    for name in ("shard_density_ema", "shard_union_ema"):
        st[name] = np.array(getattr(ctl, name))
    st["report"] = ctl.report()
    return st


@contextlib.contextmanager
def decode_shapes(seen: set):
    """Every ``models.lm.decode_step`` call inside the block adds (its
    token rows, the shape of its first layer's K cache or pool leaf) to
    ``seen``."""
    orig = tlm.decode_step

    def tapped(params, cfg, token, caches, cache_len, **kw):
        seen.add((token.shape[0], tuple(caches["blocks"][0]["k"].shape)))
        return orig(params, cfg, token, caches, cache_len, **kw)
    tlm.decode_step = tapped
    try:
        yield
    finally:
        tlm.decode_step = orig


@contextlib.contextmanager
def patched(owner, name: str, value):
    """``owner.name`` is ``value`` inside the block."""
    orig = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def shifted_slots():
    """A mutation: every 'data' line reads the slots one past its own
    (``rules.slot_range`` shifted by one slot, cyclically)."""
    orig = R.slot_range
    return patched(R, "slot_range", lambda batch, mesh=None: [
        (s + 1) % batch for s in orig(batch, mesh)])


def _server(mesh, cfg, scfg) -> Server:
    params = tlm.init_lm(cfg, 0, "cpu", place=None if mesh is None else (
        lambda node: TSS.place_serve_params(node, mesh, cfg)))
    return Server(tlm, cfg, scfg, params, device="cpu", mesh=mesh)


SESSION = "s"


def session_turns(srv: Server, turn1: list, tail, max_new: int) -> dict:
    """Two serves on ``srv`` (a paged pool, chunked prefill): ``turn1``
    ((uid, prompt, max_new, sla); its last request, in slot
    len(turn1) - 1, under session ``SESSION``), then one request of the
    session whose prompt is turn 1's history (its prompt and the tokens
    whose KV it wrote) and ``tail``: admitted first, it takes slot 0 and
    adopts the chain's blocks.  Returns both turns' tokens, the session's
    final chain, those blocks of every layer's pool leaves (numpy), the
    blocks reused and the bytes ``_share_blocks`` broadcast."""
    reqs = _requests(turn1)
    reqs[-1].session_id = SESSION
    toks = {r.uid: np.asarray(r.out) for r in srv.serve(reqs)}
    hist = srv.kv_pool.lookup_session(SESSION)["history"]
    r2 = Request(uid=-1, prompt=np.concatenate([hist, tail]),
                 max_new=max_new, session_id=SESSION)
    toks[-1] = np.asarray(srv.serve([r2])[0].out)
    chain = list(srv.kv_pool.lookup_session(SESSION)["chain"])
    return {"tokens": toks, "chain": chain,
            "blocks": [{k: v[chain].numpy() for k, v in layer.items()}
                       for layer in srv._pool["blocks"]],
            "reused": srv.paged_stats()["reused_blocks"],
            "shared_bytes": srv.shared_block_bytes}


def _raised(run) -> dict:
    """``run()``, or the message of the ValueError it raised (every rank
    raises when the ranks' host loops diverge)."""
    try:
        return run()
    except ValueError as e:
        return {"raised": str(e)}


def serve_cases(mesh, device, cases: list, save_step: int = 0,
                mismatch: bool = False, forced=(), session=None,
                shifted=None) -> dict:
    """A mesh server for each case: (model config, serve config, requests
    as (uid, prompt, max_new, sla)), weights from ``init_lm(cfg, 0)``,
    built placed a layer at a time.  Returns each serve's tokens and
    controller state (with the controller as restored at construction,
    ``restored``), the rows of the gate leaf the rank kept, the mesh's
    launch counts, every rank's slot range and KV bytes
    (``Server.mesh_slots``) and each decode step's (token rows, cache
    shape), with ``save_step`` what ``save_controller(save_step)``
    returned on this rank, and with ``mismatch`` the message every rank
    raised when rank 1 handed ``_put_slots`` other tokens.  ``forced``:
    ``forced_cases`` of them (``forced``).  ``session``: (config, serve
    config, turn 1, tail, max_new) through ``session_turns``
    (``session``), then again with ``Server._share_blocks`` a no-op
    (``session_unshared``).  ``shifted``: a case (as ``cases``') served
    under ``shifted_slots`` (``shifted``).  A mutation's run gives its
    state or the message every rank raised."""
    out = []
    for cfg, scfg, spec in cases:
        srv = _server(mesh, cfg, scfg)
        restored = _state(srv, [])
        shapes: set = set()
        with decode_shapes(shapes):
            done = srv.serve(_requests(spec))
        st = _state(srv, done)
        st["restored"] = restored
        mlp = srv.params["blocks"][0]["mlp"]
        st["rows"] = mlp.get("wg_t", mlp.get("wg_q")).shape[0]
        st["launches"] = srv.mesh_launch_counts()
        st["slots"] = srv.mesh_slots()
        st["shapes"] = sorted(shapes)
        if save_step:
            st["saved"] = srv.save_controller(save_step)
        out.append(st)
    res = {"cases": out}
    if forced:
        res["forced"] = forced_cases(mesh, device, list(forced))
    if session is not None:
        cfg, scfg, *turns = session
        res["session"] = session_turns(_server(mesh, cfg, scfg), *turns)
        with patched(Server, "_share_blocks", lambda *a: None):
            res["session_unshared"] = _raised(lambda: session_turns(
                _server(mesh, cfg, scfg), *turns))
    if shifted is not None:
        def run(cfg, scfg, spec):
            mut = _server(mesh, cfg, scfg)
            return _state(mut, mut.serve(_requests(spec)))
        with shifted_slots():
            res["shifted"] = _raised(lambda: run(*shifted))
    if mismatch:
        tok = np.zeros((srv.scfg.batch, 1), np.int32)
        tok[0, 0] = int(mesh.rank == 1)
        try:
            srv._put_slots(tok, np.zeros(srv.scfg.batch, np.int32))
            res["mismatch"] = ""
        except ValueError as e:
            res["mismatch"] = str(e)
    return res


def fail_on_rank1(mesh, device, how: str) -> int:
    """Rank 1 raises (``how="raise"``) or hangs; the others return."""
    import time
    if mesh.rank == 1:
        if how == "raise":
            raise RuntimeError("rank 1 failed on purpose")
        time.sleep(600)
    return mesh.rank


# ----------------------------------------------- the placed model, forced --

FORCED_B, FORCED_PLEN, FORCED_STEPS, FORCED_CHUNK = 4, 11, 3, 8
FORCED_MAX_LEN, FORCED_BLOCK = 32, 8
FORCED_LENS = (5, 9, 12, 20)          # the paged kind's slot lengths


@contextlib.contextmanager
def mlp_inputs(record=None, replay=None):
    """Every MLP call of ``models.lm`` appends its input to ``record`` or
    takes its input from the front of ``replay`` (numpy arrays), so a
    second run selects what the first one's inputs select."""
    orig = tlm.mlp_apply

    def tapped(params, x, cfg, **kw):
        if replay is not None:
            x = torch.from_numpy(replay.pop(0)).to(x.device, x.dtype)
        if record is not None:
            record.append(x.cpu().numpy().copy())
        return orig(params, x, cfg, **kw)
    tlm.mlp_apply = tapped
    try:
        yield
    finally:
        tlm.mlp_apply = orig


@contextlib.contextmanager
def kv_codes(record=None, replay=None):
    """Every int8 K/V quantization of ``layers.attention`` appends its
    (codes, float32 scales) to ``record``, or returns the front of
    ``replay`` (numpy), so a second run stores the codes the first one
    stored, also where a value lies within rounding of a code boundary.
    A replayed quantization still computes its own: its codes must lie
    within one code step of the replayed ones and its scales within one
    bfloat16 step (2^-7 of themselves), or it raises, so a fault in the
    K/V the first run quantized cannot hide in the replay."""
    orig = A._quantize_kv

    def tapped(x):
        q, sc = orig(x)
        if replay is not None:
            q_r, sc_r = replay.pop(0)
            code = (q.int() - torch.from_numpy(q_r).int()).abs()
            gap = np.abs(sc.float().numpy() - sc_r)
            if int(code.max()) > 1 or bool((gap > 2.0 ** -7
                                            * np.abs(sc_r)).any()):
                raise AssertionError(
                    f"int8 K/V quantization: own codes up to "
                    f"{int(code.max())} steps and scales up to "
                    f"{float(gap.max()):.3e} from the replayed ones")
            return torch.from_numpy(q_r), torch.from_numpy(sc_r).to(
                torch.bfloat16)
        if record is not None:
            record.append((q.numpy().copy(), sc.float().numpy().copy()))
        return q, sc
    A._quantize_kv = tapped
    try:
        yield
    finally:
        A._quantize_kv = orig


def whole_pool(cfg) -> dict:
    """A seeded random paged pool of the whole model (every KV head):
    float values, or int8 codes with positive bfloat16 scales."""
    gen = torch.Generator().manual_seed(9)
    n_blocks = FORCED_B * FORCED_MAX_LEN // FORCED_BLOCK + 2
    pool = tlm.init_kv_pool(cfg, n_blocks, FORCED_BLOCK, "cpu")
    for layer in pool["blocks"]:
        for name, leaf in layer.items():
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape,
                                         generator=gen, dtype=torch.int8))
            elif name.endswith("_scale"):
                leaf.copy_((torch.rand(leaf.shape, generator=gen) * 0.02
                            + 0.001).to(leaf.dtype))
            else:
                leaf.copy_(torch.randn(leaf.shape, generator=gen))
    return pool


def perturbed(place=None):
    """A ``place`` for ``init_lm`` that first draws every norm scale and QKV
    bias of the node from one seeded generator (ones and zeros would hide
    their placement), then places it with ``place`` (None: as it is).
    ``init_lm`` hands the same nodes over in the same order in every
    process, so every process draws the same values."""
    gen = torch.Generator().manual_seed(1)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("scale", "bq", "bk", "bv"):
                node[k] = (torch.randn(v.shape, generator=gen) * 0.3).to(
                    v.dtype)

    def fn(node):
        walk(node)
        return node if place is None else place(node)
    return fn


def forced_table() -> torch.Tensor:
    """(B, nbps) int32: each slot's blocks, interleaved across slots."""
    nbps = FORCED_MAX_LEN // FORCED_BLOCK
    ids = np.arange(FORCED_B * nbps).reshape(nbps, FORCED_B).T + 2
    return torch.as_tensor(ids, dtype=torch.int32)


def forced_steps(params, cfg, kind: str, pool=None, mesh=None) -> dict:
    """A batch of 4 through the decode model of ``cfg``, teacher-forced:
    ``kind`` "dense" (a monolithic prefill, then decode steps), "chunk"
    (``prefill_chunk`` in chunks of 8, then decode steps) or "paged"
    (decode steps against ``pool`` with ``forced_table``).  Per-slot
    alphas, stats on.  On a rank of ``mesh`` the model gets the slots of
    the rank's 'data' line (``rules.slot_range``): their prompts, tokens,
    alphas, lengths and table rows.  Returns the float32 logits (the
    prefill's, if any, then every step's) and the stats of every step of
    the model's slots, numpy."""
    rng = np.random.default_rng(5)
    rows = list(R.slot_range(FORCED_B, mesh))
    b, plen = len(rows), FORCED_PLEN
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (FORCED_B, plen)))[rows]
    forced = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (FORCED_STEPS, FORCED_B, 1)))
    forced = forced[:, rows]
    alphas = (cfg.sparse.alpha_schedule().alphas(cfg.n_layers)[:, None]
              + np.asarray([0.0, -0.02, 0.02, 0.05], np.float32)[None])
    alphas = alphas[:, rows]
    logits, stats, table = [], [], None
    with torch.inference_mode():
        if kind == "dense":
            lg, caches = tlm.prefill(params, cfg, prompt, FORCED_MAX_LEN)
            logits.append(lg)
            lengths = torch.full((b,), plen)
        elif kind == "chunk":
            caches = tlm.init_caches(cfg, b, FORCED_MAX_LEN, "cpu")
            pad = -(-plen // FORCED_CHUNK) * FORCED_CHUNK
            toks = torch.zeros((b, pad), dtype=prompt.dtype)
            toks[:, :plen] = prompt
            for off in range(0, pad, FORCED_CHUNK):
                lg, caches, _ = tlm.prefill_chunk(
                    params, cfg, toks[:, off:off + FORCED_CHUNK], caches,
                    off, plen, alphas=alphas, collect_stats=True)
            logits.append(lg)
            lengths = torch.full((b,), plen)
        else:
            caches, table = pool, forced_table()[rows]
            lengths = torch.as_tensor(FORCED_LENS)[rows]
        for t in range(FORCED_STEPS):
            lg, caches, st = tlm.decode_step(
                params, cfg, forced[t], caches, lengths + t, alphas=alphas,
                collect_stats=True, block_table=table)
            logits.append(lg)
            stats.append(st)
    return {"logits": torch.stack(logits).float().numpy(),
            "stats": {k: torch.stack([s[k] for s in stats]).numpy()
                      for k in stats[0]}}


def forced_cases(mesh, device, cases: list) -> list:
    """For each case (config with its grid, kind): the weights of
    ``init_lm(cfg, 0)`` with ``perturbed`` scales and biases, placed a
    table and a layer at a time, prepared,
    ``forced_steps`` under the mesh (the paged kind on this rank's KV
    heads of ``whole_pool``), with the MLP inputs recorded on rank 0 and
    every rank's int8 K/V codes of its KV heads."""
    out = []
    for cfg, kind in cases:
        params = tlm.init_lm(cfg, 0, "cpu", place=perturbed(
            lambda node: TSS.place_serve_params(node, mesh, cfg)))
        params = tlm.prepare_sparse(params, cfg.sparse)
        pool = None
        if kind == "paged":
            # this rank's KV heads: dim 2 of every pool leaf (N, block, K,
            # hd) and (N, block, K)
            split = R.attention_heads(cfg.n_heads, cfg.n_kv_heads, mesh)
            pool = {"blocks": [
                {k: v[:, :, split.k0:split.k1].clone()
                 for k, v in layer.items()}
                for layer in whole_pool(cfg)["blocks"]]}
        rec, codes = [], []
        with R.use_mesh(mesh), mlp_inputs(record=rec), \
                kv_codes(record=codes):
            got = forced_steps(params, cfg, kind, pool, mesh)
        out.append(gather_forced(got, rec, codes, mesh))
    return out


def _gather_np(a: np.ndarray, mesh, dim: int = 0) -> np.ndarray:
    """``a``'s slot dim ``dim`` gathered over 'data' in line order."""
    t = torch.from_numpy(np.ascontiguousarray(a)).movedim(dim, 0)
    return R.gather_slots(t, mesh).movedim(0, dim).numpy()


def gather_forced(got: dict, rec: list, codes: list, mesh) -> dict:
    """``forced_steps``' outputs of a line's slots, its MLP inputs and
    int8 K/V codes made every slot's: each gathered over 'data' along its
    slot dim (logits (n, b, V), stats (steps, L, b, ...), inputs and codes
    (b, ...)), the same on every rank; the inputs kept on rank 0."""
    got = {"logits": _gather_np(got["logits"], mesh, 1),
           "stats": {k: _gather_np(v, mesh, 2)
                     for k, v in got["stats"].items()}}
    rec = [_gather_np(x, mesh) for x in rec]
    got["inputs"] = rec if mesh.rank == 0 else None
    got["kv_codes"] = [tuple(_gather_np(c, mesh) for c in qs)
                       for qs in codes]
    return got


def placed_cases(mesh, device, plan: list) -> list:
    """One spawn's work for the placement tests, for each entry of
    ``plan``: (mesh shape over ('data', 'model'), forced cases, steps,
    serves).  A shape other than the spawn's is laid over the same ranks
    (``launch.mesh.make_mesh``: every rank makes it, in plan order), so one
    spawn of four ranks serves 1x4 and 2x2.  Per entry: ``forced_cases``
    of the forced cases; for each step (config with its grid, prompts (B,
    S)) a prefill and one decode step with stats on ``perturbed``
    weights, their logits and stats (what the JAX package's mesh decode
    test runs); ``serve_cases`` of the serves."""
    from repro_torch.launch.mesh import make_mesh
    results = []
    for shape, forced, steps, serves in plan:
        m = (mesh if tuple(shape) == tuple(mesh.shape)
             else make_mesh(shape, ("data", "model")))
        out = []
        for cfg, prompt in steps:
            params = tlm.prepare_sparse(tlm.init_lm(
                cfg, 0, "cpu", place=perturbed(
                    lambda node: TSS.place_serve_params(node, m, cfg))),
                cfg.sparse)
            # the rank's 'data' line's sequences, every slot's gathered
            toks = torch.as_tensor(prompt)[list(R.slot_range(len(prompt),
                                                             m))]
            with torch.inference_mode(), R.use_mesh(m):
                lg0, caches = tlm.prefill(params, cfg, toks, FORCED_MAX_LEN)
                lg, _, st = tlm.decode_step(params, cfg, toks[:, -1:],
                                            caches, toks.shape[1],
                                            collect_stats=True)
                lg0, lg = R.gather_slots(lg0, m), R.gather_slots(lg, m)
                st = {k: R.gather_slots(v.movedim(1, 0), m).movedim(0, 1)
                      for k, v in st.items()}
            out.append({"prefill": lg0.numpy(), "logits": lg.numpy(),
                        "stats": _np(st)})
        results.append({
            "forced": forced_cases(m, device, list(forced)), "steps": out,
            "serves": serve_cases(m, device, list(serves))["cases"]
            if serves else []})
    return results


# ------------------------------------------------------------- training --

def _whole(tree, layout):
    """Every leaf of a rank's ``tree`` gathered whole (on rank 0; None on
    the others)."""
    from repro_torch.sharding import train as ST
    from repro_torch.tree import flatten, unflatten
    shards = [s for _, s in flatten(layout)]
    got = [ST.whole_leaf(t.detach(), s)
           for (_, t), s in zip(flatten(tree), shards)]
    return None if got[0] is None else unflatten(tree, got)


def _placed_trainer(mesh, cfg, weights, dkw: dict, okw: dict, tkw: dict):
    """A mesh ``Trainer`` on the reference's ``weights`` (numpy, its
    layout), each rank holding its part."""
    from repro_torch import bridge
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    from repro_torch.optim.compress import init_ef
    from repro_torch.runtime import trainer as TT
    from repro_torch.sharding import train as ST
    t = TT.Trainer(tlm, cfg, TT.TrainerConfig(**tkw), AdamWConfig(**okw),
                   DataConfig(**dkw), device="cpu", mesh=mesh)
    t.init_state(seed=0)
    if weights is not None:
        t.params = TT._trainable(ST.place_train_params(
            bridge.params_from_numpy(weights, cfg, "cpu"), mesh, cfg))
        t.opt_state = init_adamw(t.params)
        t.ef_state = init_ef(t.params) if tkw.get("grad_compression") \
            else ()
    return t


def train_suite(mesh, device, suite: dict) -> dict:
    """The training checks of one mesh spawn, each part of ``suite``
    optional:

    - "grads": (meshes, [(cfg, reference weights, batch (numpy, B
      rows))]): on each mesh ((shape, axes) over the spawn's ranks, made
      in turn by every rank) the loss and every gradient leaf of
      ``lm_loss`` on the rank's part of the weights and its line's rows;
      per mesh and case the loss of every rank and the whole gradients
      (rank 0);
    - "codes": (cfg, a whole gradient tree): ``compress_grads`` of the
      rank's parts; the whole codes and scales (rank 0);
    - "train": [(cfg, weights, data, opt and trainer kwargs)]: a mesh
      ``Trainer`` run; its history and whole params after it (rank 0);
    - "resume": (cfg, data, opt, trainer kwargs, steps): a fresh mesh
      ``Trainer`` resumed from the checkpoint directory; whether every
      restored leaf equals its part of the stored whole leaf bit for bit,
      the step it resumed at and the history of ``steps`` more."""
    from repro_torch import bridge
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import compress as GC
    from repro_torch.sharding import train as ST
    from repro_torch.tree import flatten, unflatten
    out: dict = {}
    meshes, cases = suite.get("grads", ((), ()))
    for shape, axes in meshes:
        on = make_mesh(shape, axes)
        got = out.setdefault("grads", {})[
            "x".join(str(n) for n in shape)] = []
        for cfg, weights, batch in cases:
            layout = specs.param_shardings(cfg, on, "train")
            params = ST.place_train_params(
                bridge.params_from_numpy(weights, cfg, "cpu"), on, cfg)
            leaves = [p.requires_grad_(True) for _, p in flatten(params)]
            rows = R.slot_range(batch["tokens"].shape[0], on)
            mine = {k: torch.from_numpy(v[rows.start:rows.stop])
                    for k, v in batch.items()}
            with R.use_mesh(on), ST.use_layout(layout):
                loss, _ = tlm.lm_loss(params, cfg, mine)
                grads = torch.autograd.grad(loss, leaves)
            got.append((float(loss),
                        _whole(unflatten(params, grads), layout)))
    if "codes" in suite:
        cfg, whole = suite["codes"]
        layout = specs.param_shardings(cfg, mesh, "train")
        mine = unflatten(layout, [ST.take(torch.from_numpy(g), s) for g, s
                                  in zip((g for _, g in flatten(whole)),
                                         (s for _, s in flatten(layout)))])
        q, _ = GC.compress_grads(mine, GC.init_ef(mine), layout)
        flat_q = [v for _, v in flatten(q)]     # (codes, scale) leaves
        qs = unflatten(layout, [c for c, _ in flat_q])
        scales = [float(s) for _, s in flat_q]
        out["codes"] = (_whole(qs, layout), scales)
    for cfg, weights, dkw, okw, tkw in suite.get("train", ()):
        t = _placed_trainer(mesh, cfg, weights, dkw, okw, tkw)
        hist = t.run()
        out.setdefault("train", []).append(
            ([{k: h[k] for k in ("step", "loss", "grad_norm", "time_s")}
              for h in hist], _whole(t.params, t.layout)))
    if "resume" in suite:
        cfg, dkw, okw, tkw, steps = suite["resume"]
        t = _placed_trainer(mesh, cfg, None, dkw, okw, tkw)
        assert t.maybe_resume()
        step = t.ckpt.latest_step()
        with np.load(os.path.join(tkw["ckpt_dir"], f"step_{step:08d}",
                                  "shard_0.npz")) as data:
            stored = [data[str(i)] for i in range(len(data.files))]
        state = {"params": t.params, "mu": t.opt_state.mu,
                 "nu": t.opt_state.nu}
        same = all(
            np.array_equal(ST.take(w, s), v.detach().numpy())
            for w, (_, v), (_, s) in zip(stored, flatten(state),
                                          flatten(t._state_layout())))
        out["resume"] = {"bitwise": same, "at": t.global_step,
                         "history": [{k: h[k] for k in ("step", "loss")}
                                     for h in t.run(steps)]}
    return out


def pipe_block(w_stage: torch.Tensor, xm: torch.Tensor) -> torch.Tensor:
    """One stage of the GPipe test's stack: relu(x @ w) a layer."""
    for w in w_stage:
        xm = torch.relu(xm @ w)
    return xm


def pipeline_cases(mesh, device, ws, x, microbatches: list) -> list:
    """``pipeline_apply`` of ``pipe_block`` over the 'pipe' ranks, the
    rank holding its stage of the (n_layers, d, d) weights ``ws``; its
    output per microbatch count."""
    from repro_torch.sharding import pipeline as PP
    local = PP.local_stage(PP.stage_params(torch.from_numpy(ws),
                                           mesh.axis_size("pipe")), mesh)
    return [PP.pipeline_apply(pipe_block, local, torch.from_numpy(x),
                              mesh=mesh, n_microbatches=m).numpy()
            for m in microbatches]
