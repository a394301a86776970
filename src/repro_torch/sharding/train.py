"""The training placement of the dense family on a rank mesh: the
reference's ``param_spec(..., "train")`` applied to a rank's leaves, and
the gathers that run the model on them.

Each leaf splits over 'model' as it does in serving (the MLP's rows, the
attention's heads, the tables' vocabulary rows: ``sharding/sparse.py:
leaf_index``) and, in the same leaf, its 'fsdp' dim (the model width)
over the mesh's data lines (FSDP: line j of L keeps the j-th of L
contiguous slices, ``rules.data_axes``).  ``LeafShard`` records where a
rank's part lies in the whole leaf, for this rank and every other.

While a layout is current (``use_layout``) the training forward
(``models/lm.py:forward``, ``lm_loss``) calls ``gather`` on each node
right before its use, a block at a time inside its recomputed region, so
``torch.utils.checkpoint`` repeats the gathers in the same order on every
rank.  A gathered leaf holds this rank's 'model' part whole along its
fsdp dim, which the serve-placed model code runs on.  Its backward keeps
the rank-order rule:

* the line's full gradients are summed in line order, and a rank keeps
  its slice (a leaf split over the data lines) or all of it (a leaf whole
  over them: a norm scale, a bias, a dim the lines do not divide);
* a leaf whole over 'model' that the line's ranks use on different heads
  (qk-norm scales; the K/V leaves a rank shares with the ranks reading the
  same KV head, where the KV heads do not split) first sums the gradients
  of the ranks holding the same part, in rank order.

A leaf used alike by every rank of its 'model' line (the block norms,
whole tables) needs no sum over it: ``rules.model_entry`` has already
made the gradient reaching it the whole one on every rank.  Sums of the
whole tree (the gradient norm, compression's per-leaf scales) take each
distinct part once: a leaf's part counts on the lowest rank holding it
(``LeafShard.owner``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.sharding import rules as R
from repro_torch.sharding import sparse as SSP
from repro_torch.tree import flatten, tree_map

_LAYOUT = None


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """Where a rank's part of one leaf lies: ``whole`` shape, ``index``
    (this rank's slices of the whole leaf), ``data_dim`` (the dim split
    over the data lines, None: whole over them), ``model_peers`` (the
    'model' positions whose gradients of this part are summed, () for
    none), ``owner`` (no lower rank holds this part) and ``indices``
    (every rank's index, in rank order)."""
    whole: tuple
    index: tuple
    data_dim: Optional[int]
    model_peers: tuple
    owner: bool
    indices: tuple

    @property
    def shape(self) -> tuple:
        """This rank's part's shape."""
        return _shape_of(self.index, self.whole)


def _shape_of(index: tuple, whole: tuple) -> tuple:
    out = list(whole)
    for d, sl in enumerate(index):
        start, stop, _ = sl.indices(whole[d])
        out[d] = stop - start
    return tuple(out)


def _data_dim(spec: tuple) -> Optional[int]:
    data = {"pod", "data"}
    for d, s in enumerate(spec):
        names = (s,) if isinstance(s, str) else tuple(s or ())
        if names and set(names) <= data:
            return d
    return None


def train_index(path: str, shape: tuple, mesh, cfg) -> tuple:
    """(index, data dim) of this rank's part of a whole leaf of ``shape``
    at ``path`` (a whole tree's path or a node's relative one: the rules
    match its end) under the train rules."""
    idx = SSP.leaf_index(path, shape, mesh, cfg)
    idx = list(idx or ())
    dim = _data_dim(R.param_spec(path, shape, mesh, "train"))
    if R.data_lines(mesh) == 1:
        dim = None                     # one line holds the leaf whole
    if dim is not None:
        n, j = R.data_lines(mesh), R.data_line(mesh)
        idx += [slice(None)] * (dim + 1 - len(idx))
        idx[dim] = slice(j * shape[dim] // n, (j + 1) * shape[dim] // n)
    return tuple(idx), dim


def _model_peers(path: str, mesh, cfg) -> tuple:
    """The 'model' positions of the ranks holding this rank's part of an
    attention leaf that the line's ranks use on different heads; ()
    for every other leaf."""
    parts = path.split("/")
    if "attn" not in parts or cfg is None:
        return ()
    split = R.attention_heads(cfg.n_heads, cfg.n_kv_heads, mesh)
    if split.shards == 1:
        return ()
    m = R.model_size(mesh)
    name = parts[-1] if parts[-1] != "scale" else parts[-2]
    if name in ("q_norm", "k_norm"):
        return tuple(range(m))
    if name in ("wk", "wv", "bk", "bv") and \
            R.kv_model_axis_entries(cfg.n_kv_heads, 0, mesh)[0] != "model":
        return tuple(i for i in range(m) if R.attention_heads(
            cfg.n_heads, cfg.n_kv_heads,
            mesh.with_rank(_rank_at(mesh, i))).k0 == split.k0)
    return ()


def _rank_at(mesh, model_pos: int) -> int:
    """The rank of this rank's 'model' line at position ``model_pos``."""
    coords = mesh.coords()
    coords["model"] = model_pos
    rank = 0
    for name, size in zip(mesh.axis_names, mesh.shape):
        rank = rank * size + coords[name]
    return rank


def leaf_shard(path: str, shape: tuple, mesh, cfg) -> LeafShard:
    """The ``LeafShard`` of a whole leaf of ``shape`` at ``path`` for this
    rank of ``mesh`` (its every rank's indices too)."""
    shape = tuple(shape)
    indices = tuple(train_index(path, shape, mesh.with_rank(r), cfg)[0]
                    for r in range(mesh.size))
    index, dim = train_index(path, shape, mesh, cfg)
    return LeafShard(shape, index, dim, _model_peers(path, mesh, cfg),
                     index not in indices[:mesh.rank], indices)


def place_train_params(node, mesh, cfg):
    """This rank's part of every leaf of ``node`` (whole leaves; a tree or
    any node of one, as ``models.lm.init_lm(place=...)`` hands it over)
    under the train rules: a copy of each split leaf, so the whole one can
    be freed."""
    def walk(v, path):
        if isinstance(v, dict):
            return {k: walk(x, f"{path}/{k}" if path else k)
                    for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x, f"{path}/{i}" if path else str(i))
                    for i, x in enumerate(v)]
        idx, _ = train_index(path, tuple(v.shape), mesh, cfg)
        return v[idx].clone() if idx else v
    return walk(node, "")


def layout_of(shapes, mesh, cfg):
    """The tree of ``LeafShard`` of a whole tree (or its ``meta``
    stand-in) ``shapes``."""
    return _map_paths(lambda path, v: leaf_shard(path, tuple(v.shape), mesh,
                                                 cfg), shapes)


def _map_paths(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


# ------------------------------------------------------------ the gathers --

@contextlib.contextmanager
def use_layout(layout):
    """Make ``layout`` (a tree of ``LeafShard`` like the params; None:
    none) the current training layout inside the block."""
    global _LAYOUT
    prev = _LAYOUT
    _LAYOUT = layout
    try:
        yield layout
    finally:
        _LAYOUT = prev


class _Gather(torch.autograd.Function):
    """A rank's part of a leaf -> its 'model' part whole along the data
    dim; the backward sums the 'model' peers' gradients, then the data
    line's, in rank order, and keeps the rank's slice."""

    @staticmethod
    def forward(ctx, t, shard: LeafShard, mesh):
        ctx.shard, ctx.mesh = shard, mesh
        if shard.data_dim is None:
            return t.view_as(t)
        parts = R.gather_line(t, R.data_axis(mesh), mesh)
        return torch.cat(parts.unbind(0), dim=shard.data_dim)

    @staticmethod
    def backward(ctx, g):
        shard, mesh = ctx.shard, ctx.mesh
        g = g.contiguous()
        if shard.model_peers:
            parts = R.gather_line(g, "model", mesh).float()
            total = parts[shard.model_peers[0]]
            for p in shard.model_peers[1:]:
                total = total + parts[p]
            g = total.to(g.dtype)
        if R.data_lines(mesh) > 1:
            g = R.ordered_sum(g, R.data_axis(mesh), mesh)
        if shard.data_dim is not None:
            n = g.shape[shard.data_dim] // R.data_lines(mesh)
            g = g.narrow(shard.data_dim, R.data_line(mesh) * n, n)
        return g, None, None


def gather(node, *path):
    """``node`` (the params' subtree at ``path``: keys and layer indices)
    with each leaf gathered for use under the current layout and mesh;
    ``node`` itself without a current layout."""
    layout, mesh = _LAYOUT, R.current_mesh()
    if layout is None or mesh is None:
        return node
    for p in path:
        layout = layout[p]

    def one(t, shard):
        if (shard.data_dim is None and not shard.model_peers
                and R.data_lines(mesh) == 1):
            return t
        return _Gather.apply(t, shard, mesh)
    return tree_map(one, node, layout)


# --------------------------------------------------- sums over the tree --

def _world_parts(vec: torch.Tensor) -> torch.Tensor:
    """(world, ...): ``vec`` of every rank, in rank order."""
    parts = [torch.empty_like(vec) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, vec.contiguous())
    return torch.stack(parts)


def tree_sum(per_leaf: list, layout) -> torch.Tensor:
    """(n,) per-leaf totals over the whole tree of the per-leaf local
    values ``per_leaf`` (float32 scalars, walk order): each distinct part
    counted once, on its owner, summed over the ranks in rank order."""
    owners = [s.owner for _, s in flatten(layout)]
    local = torch.stack([v if own else torch.zeros_like(v)
                         for v, own in zip(per_leaf, owners)])
    parts = _world_parts(local)
    total = parts[0]
    for r in range(1, parts.shape[0]):
        total = total + parts[r]
    return total


def world_max(vec: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``vec`` over every rank (exact in any
    order)."""
    return _world_parts(vec).amax(0)


# ------------------------------------------------------------ whole leaves --

def whole_leaf(t: torch.Tensor, shard: LeafShard) -> Optional[torch.Tensor]:
    """The whole leaf of which ``t`` is this rank's part, assembled from
    every rank's part (a collective: every rank calls it); None on ranks
    other than 0."""
    parts = _world_parts(t)
    if dist.get_rank() != 0:
        return None
    out = torch.empty(shard.whole, dtype=t.dtype, device=t.device)
    for idx, part in zip(shard.indices, parts):
        out[idx] = part
    return out


def take(whole: torch.Tensor, shard: LeafShard) -> torch.Tensor:
    """This rank's part of a whole leaf."""
    return whole[shard.index] if shard.index else whole

