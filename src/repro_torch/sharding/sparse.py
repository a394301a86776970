"""Shard-grid checks and the placement of the tensor-parallel sparse
decode: the counterpart of ``repro/sharding/sparse.py:34-187``.

``SparseInferConfig.tp_shards`` (ms) splits the FFN hidden dim k into ms
contiguous row slices, each with its own batch union and top-C/ms
selection; ``dp_shards`` (ds) splits the batch slots into ds blocks, each
with its own unions (``runtime/distributed.py`` runs that grid).  The
checks decide whether a config can run at all, on one device or on a rank
mesh (``launch/mesh.py``) whose axes divide the grid.

Placement keeps, on each rank of a mesh, its model tiles' rows of the
sparse-MLP leaves (``SPARSE_MLP_KEYS``: the sign bits are packed along d,
so a tile's margins, union and selection need nothing from other ranks);
every other leaf is replicated.  ``place_serve_params`` slices one node at
a time, so ``models.lm.init_lm(place=...)`` builds a rank's tree a layer at
a time and never holds every layer's full MLP.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import quantize as Q
from repro_torch.sharding import rules as R

# the neuron-major sparse-MLP leaves, row-sharded over 'model': every one's
# dim 0 is proportional to k (int8 tiles k rows, wd's scales k/qg), so a
# rank's share of a leaf of r rows is r/m_mesh rows
SPARSE_MLP_KEYS = ("wg_t", "wu_t", "wd_t", "sign_wg",
                   "wg_q", "wg_s", "wu_q", "wu_s", "wd_q", "wd_s")


def mesh_shard_count(mesh=None) -> int:
    """Size of the 'model' axis (None: the current mesh; 1 without one)."""
    mesh = mesh or R.current_mesh()
    return 1 if mesh is None else mesh.axis_size("model")


def mesh_data_count(mesh=None) -> int:
    """Size of the 'data' axis (None: the current mesh; 1 without one)."""
    mesh = mesh or R.current_mesh()
    return 1 if mesh is None else mesh.axis_size("data")


def mesh_divides(ds: int, ms: int, mesh=None) -> tuple[int, int]:
    """The ('data', 'model') sizes of ``mesh`` (None: the current mesh),
    which must divide the (ds, ms) grid: each rank loops over its
    contiguous tiles."""
    d_mesh, m_mesh = mesh_data_count(mesh), mesh_shard_count(mesh)
    for name, n, axis, n_mesh in (("tp_shards", ms, "model", m_mesh),
                                  ("dp_shards", ds, "data", d_mesh)):
        if n % n_mesh:
            raise ValueError(
                f"{name}={n} but the mesh's {axis!r} axis has {n_mesh} "
                "ranks: the mesh axis must evenly divide the semantic shard "
                "count")
    return d_mesh, m_mesh


def resolve_grid(sparse, mesh, batch: int) -> tuple[int, int]:
    """The semantic (ds, ms) grid for serving on ``mesh`` (None: the
    current mesh, none outside ``rules.use_mesh``).  The config's explicit
    ``dp_shards``/``tp_shards`` win; unset ones take the mesh's axis sizes,
    which must divide them (each rank loops over its contiguous tiles), and
    the batch must split evenly over the data shards."""
    ms = sparse.tp_shards or mesh_shard_count(mesh)
    ds = sparse.dp_shards or mesh_data_count(mesh)
    mesh_divides(ds, ms, mesh)
    if batch % ds:
        raise ValueError(
            f"batch {batch} not divisible by dp_shards={ds}: every data "
            "shard owns the same number of batch slots")
    return ds, ms


def validate_shardable(sparse, k: int, ms: int) -> None:
    """Fail fast if ``sparse`` cannot split ``k`` rows ``ms`` ways: every
    shard needs whole row groups, whole int8 quant groups, and every rung
    of the capacity ladder must split evenly over the shards.  ``k`` is
    the sparse MLP layers' width: a moe config with no dense first layer
    has none to check (the server skips it)."""
    if ms <= 1:
        return
    g = sparse.group_size
    if k % (ms * g):
        raise ValueError(
            f"d_ff={k} not divisible by tp_shards={ms} x group_size={g}")
    if getattr(sparse, "weight_dtype", "") == "int8":
        qg = sparse.quant_group_size
        if (k // ms) % qg:
            raise ValueError(
                f"per-shard rows k/ms={k // ms} not divisible by "
                f"quant_group_size={qg}: every shard must own whole wd "
                "quant row groups")
    for capg in sparse.capacity_ladder(k):
        # shard_capacity raises with the offending rung in the message
        dataclasses.replace(sparse, tp_shards=ms,
                            capacity_override=capg).shard_capacity(k)


# ------------------------------------------------------------ placement --

def mlp_param_spec(name: str, shape: tuple) -> tuple:
    """A leaf's placement: ``("model", None)`` row-shards a sparse-MLP
    leaf over 'model' (leading stack dims stay whole); ``()`` replicates
    every other leaf."""
    if name not in SPARSE_MLP_KEYS or len(shape) < 2:
        return ()
    return (None,) * (len(shape) - 2) + ("model", None)


def _rows_kept(spec: tuple, shape: tuple, mesh) -> Optional[tuple]:
    """The index of the part of a leaf this rank keeps under ``spec``
    (None: all of it)."""
    if "model" not in spec:
        return None
    m = mesh_shard_count(mesh)
    dim = spec.index("model")
    rows = shape[dim]
    if rows % m:
        raise ValueError(f"{rows} rows do not split over the mesh's "
                         f"'model' axis ({m} ranks)")
    i = mesh.axis_index("model") if m > 1 else 0
    return (slice(None),) * dim + (slice(i * rows // m,
                                         (i + 1) * rows // m),)


def serve_param_shardings(params, mesh=None):
    """The tree of ``params`` with, for each leaf, the index of the rows
    this rank of ``mesh`` keeps (a sparse-MLP leaf's share over 'model')
    or None (replicated: the whole leaf)."""
    mesh = mesh or R.current_mesh()

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        if node is None or mesh is None:
            return None
        return _rows_kept(mlp_param_spec(name, tuple(node.shape)),
                          tuple(node.shape), mesh)
    return walk(params)


def place_serve_params(params, mesh=None):
    """Keep this rank's rows of every sparse-MLP leaf of a whole tree (a
    copy, so the whole leaf can be freed) and every other leaf as it is."""
    mesh = mesh or R.current_mesh()
    if mesh_shard_count(mesh) == 1:
        return params

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return node
        if "wg_t" in node or "wg_q" in node:
            keep = serve_param_shardings(node, mesh)
            return {k: (v if keep[k] is None else v[keep[k]].clone())
                    for k, v in node.items()}
        return {k: walk(v) for k, v in node.items()}
    return walk(params)


def check_placed(params, mesh, d_ff: int) -> None:
    """Raise unless every MLP node of ``params`` holds this rank's share
    of the d_ff hidden rows: d_ff / the 'model' axis's size."""
    want = d_ff // mesh_shard_count(mesh)

    def walk(node, path):
        if isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif isinstance(node, dict):
            if "wg_t" in node or "wg_q" in node:
                rows = Q.mlp_hidden_rows(node)
                if rows != want:
                    raise ValueError(
                        f"MLP node {path or '/'} holds {rows} hidden rows, "
                        f"not this rank's {want} of d_ff={d_ff}: place the "
                        "tree first (init_lm(place=...) or "
                        "place_serve_params)")
                return
            for k, v in node.items():
                walk(v, f"{path}/{k}")
    walk(params, "")
