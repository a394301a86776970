"""Rank bodies of the mesh tests (``tests/test_torch_mesh_*.py``): each runs
on every spawned rank of ``repro_torch.launch.ranks.run_ranks`` and imports
only torch, numpy and ``repro_torch`` (a spawned rank never imports JAX).
Each returns numpy values the test process holds against its own."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import sparse_mlp as TSM
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


def apply_cases(mesh, device, cases: list) -> list:
    """``core.sparse_mlp.apply`` under the mesh for each case: (params
    (numpy, whole), x, alpha, port config, return_stats); an x of (B, S, d)
    goes through ``mlp_apply`` as a prefill's rows (the sharded config's
    dense MLP).  The rank places the params itself; per case it returns y,
    the stats (or None) and the rows of the gate leaf it kept."""
    out = []
    for params, x, alpha, cfg, stats in cases:
        whole = {k: torch.from_numpy(v) for k, v in params.items()}
        mine = TSS.place_serve_params(whole, mesh)
        with torch.inference_mode(), R.use_mesh(mesh):
            if x.ndim == 3:             # a prefill's rows: the dense MLP
                got = mlp_apply(mine, torch.from_numpy(x), cfg, prefill=True,
                                return_stats=stats)
            else:
                got = TSM.apply(mine, torch.from_numpy(x), cfg,
                                alpha=torch.from_numpy(np.asarray(alpha)),
                                return_stats=stats)
        y, st = _np(got) if stats else (_np(got), None)
        out.append({"y": y, "stats": st,
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


def serve_cases(mesh, device, cases: list, save_step: int = 0,
                mismatch: bool = False) -> dict:
    """A mesh server for each case: (model config, serve config, requests
    as (uid, prompt, max_new, sla)), weights from ``init_lm(cfg, 0)``,
    built placed a layer at a time.  Returns each serve's tokens and
    controller state (with the controller as restored at construction,
    ``restored``), the rows of the gate leaf the rank kept, the mesh's
    launch counts, with ``save_step`` what ``save_controller(save_step)``
    returned on this rank, and with ``mismatch`` the message every rank
    raised when rank 1 handed ``_put_slots`` other tokens."""
    out = []
    for cfg, scfg, spec in cases:
        params = tlm.init_lm(cfg, 0, "cpu", place=lambda blk: (
            TSS.place_serve_params(blk, mesh)))
        srv = Server(tlm, cfg, scfg, params, device="cpu", mesh=mesh)
        restored = _state(srv, [])
        done = srv.serve(_requests(spec))
        st = _state(srv, done)
        st["restored"] = restored
        mlp = srv.params["blocks"][0]["mlp"]
        st["rows"] = mlp.get("wg_t", mlp.get("wg_q")).shape[0]
        st["launches"] = srv.mesh_launch_counts()
        if save_step:
            st["saved"] = srv.save_controller(save_step)
        out.append(st)
    res = {"cases": out}
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
