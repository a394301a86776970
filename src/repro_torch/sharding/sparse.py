"""Shard-grid checks and the placement of the tensor-parallel sparse
decode: the counterpart of ``repro/sharding/sparse.py:34-187``.

``SparseInferConfig.tp_shards`` (ms) splits the FFN hidden dim k into ms
contiguous row slices, each with its own batch union and top-C/ms
selection; ``dp_shards`` (ds) splits the batch slots into ds blocks, each
with its own unions (``runtime/distributed.py`` runs that grid).  The
checks decide whether a config can run at all, on one device or on a rank
mesh (``launch/mesh.py``) whose axes divide the grid.  On a mesh of D
'data' lines, line j owns the slots of ``rules.slot_range`` (block db lies
on line db // (ds/D)) and runs its decode step on them alone.

Placement keeps, on each rank of a mesh, its part of every leaf by the
reference's serve rules (``rules.param_spec``): its model tiles' rows of
the sparse-MLP leaves (the sign bits are packed along d, so a tile's
margins, union and selection need nothing from other ranks), its heads
of the attention's in-projections, biases and ``wo``
(``rules.attention_heads``), its vocabulary rows of the embedding and head
tables; norms stay whole.  ``place_serve_params`` slices one node at a
time, so ``models.lm.init_lm(place=...)`` builds a rank's tree a layer at
a time and never holds every layer whole.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import quantize as Q
from repro_torch.sharding import rules as R
from repro_torch.tree import tree_bytes


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

# the attention leaves split by whole heads (``rules.attention_heads``):
# name -> (which heads, the dim they lie along)
_HEAD_LEAVES = {"wq": ("q", -1), "bq": ("q", 0), "wo": ("q", 0),
                "wk": ("k", -1), "bk": ("k", 0), "wv": ("k", -1),
                "bv": ("k", 0)}


def leaf_index(path: str, shape: tuple, mesh, cfg) -> Optional[tuple]:
    """The index of the part of a whole leaf this rank keeps (None: all of
    it): an attention leaf's heads (``cfg``'s), else the dim the
    reference's serve rules split over 'model', this rank's contiguous
    share of it."""
    name = path.rsplit("/", 1)[-1]
    if name in _HEAD_LEAVES and "attn" in path.split("/"):
        if cfg is None:
            raise ValueError(f"{path}: placing an attention leaf needs the "
                             "model config (its heads)")
        split = R.attention_heads(cfg.n_heads, cfg.n_kv_heads, mesh)
        if split.shards == 1:
            return None
        which, dim = _HEAD_LEAVES[name]
        lo, hi = ((split.q0, split.q1) if which == "q"
                  else (split.k0, split.k1))
        hd = cfg.resolved_head_dim
        dim %= len(shape)
        return (slice(None),) * dim + (slice(lo * hd, hi * hd),)
    spec = R.param_spec(path, shape, mesh)
    if "model" not in spec:
        return None
    m, dim = mesh.axis_size("model"), spec.index("model")
    i = mesh.axis_index("model")
    return (slice(None),) * dim + (slice(i * shape[dim] // m,
                                         (i + 1) * shape[dim] // m),)


def serve_param_shardings(params, mesh=None, cfg=None):
    """The tree of ``params`` (a whole tree, or any node of one: paths are
    relative, and the rules match their ends) with, for each leaf, the
    index of the part this rank of ``mesh`` keeps, or None (the whole
    leaf): the reference's serve rules (``rules.param_spec``), the
    attention leaves by ``cfg``'s heads."""
    mesh = mesh or R.current_mesh()

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}/{i}" if path else str(i))
                              for i, v in enumerate(node))
        if node is None or mesh is None or R.model_size(mesh) == 1:
            return None
        return leaf_index(path, tuple(node.shape), mesh, cfg)
    return walk(params, "")


def place_serve_params(params, mesh=None, cfg=None):
    """This rank's part of every leaf of ``params`` (a whole tree or a node
    of one; ``cfg`` places the attention leaves by heads): a copy of each
    split leaf, so the whole one can be freed, and every other leaf as it
    is."""
    mesh = mesh or R.current_mesh()
    keep = serve_param_shardings(params, mesh, cfg)

    def walk(node, idx):
        if isinstance(node, dict):
            return {k: walk(v, idx[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, i) for v, i in zip(node, idx))
        return node if idx is None else node[idx].clone()
    return walk(params, keep)


def _split_leaves(params, mesh, cfg):
    """(path, node or leaf, its extent, this rank's extent, the whole
    extent) of everything a rank of ``mesh`` holds a part of in a dense
    tree (whole or placed), by the extents ``cfg`` gives: an MLP node by
    its hidden rows (every leaf of it scales with them), the attention's
    head leaves along their head dim, the tables by vocabulary.  The
    other leaves are whole on every rank."""
    m = R.model_size(mesh)
    # every rank's parts have the same extents: a mesh made without a
    # process group (no rank) answers as its rank 0
    probe = mesh if mesh.rank is not None else dataclasses.replace(mesh,
                                                                   rank=0)
    split = R.attention_heads(cfg.n_heads, cfg.n_kv_heads, probe)
    hd = cfg.resolved_head_dim
    heads = {"q": ((split.q1 - split.q0) * hd, cfg.n_heads * hd),
             "k": ((split.k1 - split.k0) * hd, cfg.n_kv_heads * hd)}
    vocab = cfg.vocab_padded
    tables = (vocab // m if vocab % m == 0 else vocab, vocab)

    def walk(node, path):
        if isinstance(node, list):
            for i, v in enumerate(node):
                yield from walk(v, f"{path}/{i}")
            return
        if not isinstance(node, dict):
            return
        if "wg_t" in node or "wg_q" in node:
            yield (path or "/", node, Q.mlp_hidden_rows(node),
                   cfg.d_ff // m, cfg.d_ff)
            return
        for k, v in node.items():
            if isinstance(v, (dict, list)):
                yield from walk(v, f"{path}/{k}")
            elif k in _HEAD_LEAVES and path.endswith("attn"):
                dim = _HEAD_LEAVES[k][1] % v.ndim
                yield (f"{path}/{k}", v, v.shape[dim]) + heads[
                    _HEAD_LEAVES[k][0]]
            elif k == "table":
                yield (f"{path}/{k}", v, v.shape[0]) + tables
    yield from walk(params, "")


def check_placed(params, mesh, cfg) -> None:
    """Raise unless ``params`` holds this rank's part of every leaf the
    mesh splits: d_ff / the 'model' axis's hidden rows of each MLP node,
    its heads' columns and rows of the attention, its vocabulary rows of
    the tables."""
    for path, v, held, part, _ in _split_leaves(params, mesh, cfg):
        if held != part:
            what = ("hidden rows" if isinstance(v, dict)
                    else "along its split dim")
            raise ValueError(
                f"{path} holds {held} {what}, not this rank's {part}: a rank "
                "holds its part of every leaf (d_ff / "
                f"{R.model_size(mesh)} hidden rows of each MLP node among "
                "them); place the tree first (init_lm(place=...) or "
                "place_serve_params)")


def one_device_bytes(params, mesh, cfg) -> int:
    """The bytes of the whole tree of which ``params`` is this rank's
    part (a split node or leaf counted at its whole extent)."""
    total = tree_bytes(params)
    for _, v, held, _, whole in _split_leaves(params, mesh, cfg):
        total += tree_bytes(v) * (whole - held) // held
    return total
