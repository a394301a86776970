"""The mesh context, the partition rules and the rank-order combines of
the placed paths: the counterpart of ``repro/sharding/rules.py``.

``use_mesh`` makes a ``launch.mesh.RankMesh`` the current mesh of this
process; the sparse MLP's dispatch (``runtime/distributed.py:
sharded_apply``), the dense MLP (``layers/mlp.py``), the attention's head
split (``models/common.py:attn_cfg``) and the vocabulary split of the
embedding and the head read it.  Inside ``shard_local`` every helper sees
no mesh: the tile loop of ``shard_map_apply`` works on a rank's own
values.  The reference's ``mesh_axes`` and ``axis_size`` are
``RankMesh.axis_names`` and ``RankMesh.axis_size`` here; its ``tp_axis``
is always 'model' and its ``data_axes`` 'pod' then 'data', each where the
mesh has it (``data_axes``): a ``(pod, data, model)`` mesh has one data
line per (pod, data) pair, in that order.

The reference's name-and-shape rules (``_PARAM_RULES``, ``_filter_spec``,
``param_spec``) are ported in both modes: a spec names, for each dim of a
leaf, the mesh axes it is split over or None, and a dim the axes do not
divide stays whole.  In "serve" mode weights split over 'model' only; in
"train" mode a weight's other big dim also splits over the data axes
(FSDP: each data line keeps a slice; ``sharding/train.py`` gathers it
before each use).  There is no GSPMD to apply them: a rank keeps its
slice of each leaf (``sharding/sparse.py:place_serve_params``,
``sharding/train.py:place_train_params``) and the model code runs on it,
combining partial results over the 'model' line with ``model_sum`` and
``model_concat`` (gathers in rank order, so every rank holds the same
bits on gloo and on NCCL).

Each combine has a backward that keeps the rank-order rule, so the
placed model trains (the reference's GSPMD transposes its collectives):
``model_sum`` of partials every rank then uses alike passes the gradient
through to the rank's partial; ``model_entry`` marks where a replicated
activation enters rank-split weights (identity forward; backward: the
ranks' input gradients through ``model_sum``); ``model_concat``'s
backward takes the rank's piece.

Two deliberate differences, both of placement only: attention leaves are
split by whole heads (``attention_heads``), and the decode caches are
split by KV heads (``kv_model_axis_entries``; ``models/common.py:
attn_cfg`` gives the cache makers a rank's KV heads) where the reference
splits them by sequence; where the KV heads do not split over the 'model'
axis a rank keeps the one KV head its query heads read (MQA: every rank
keeps it).  The reference's activation constraints
(``shard_tokens``, ``shard_heads``, ...) have no counterpart: a rank's
activations are its own tensors.

The batch slots split over the data lines as the reference's
``slot_sharding`` places them: a rank's data line owns the contiguous
slots (or a training batch's rows) of ``slot_range``, its decode step
runs on those B/D rows only and its dense caches hold those slots;
``gather_slots`` brings every line's rows together in line order.  The
model code never reads the data axes: its tensors simply have B/D rows,
and the combines above run over 'model'.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re

import torch
import torch.distributed as dist

_MESH = None
_SHARD_LOCAL = False


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (None: none) the current mesh inside the block."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


@contextlib.contextmanager
def shard_local():
    """Every mesh-sensitive helper behaves as if no mesh were current."""
    global _SHARD_LOCAL
    prev = _SHARD_LOCAL
    _SHARD_LOCAL = True
    try:
        yield
    finally:
        _SHARD_LOCAL = prev


def current_mesh():
    return None if _SHARD_LOCAL else _MESH


def model_size(mesh=None) -> int:
    """The 'model' axis's size (None: the current mesh; 1 without one)."""
    mesh = mesh or current_mesh()
    return 1 if mesh is None else mesh.axis_size("model")


def data_axes(mesh=None) -> tuple:
    """The mesh's data axes, 'pod' then 'data', each where present."""
    mesh = mesh or current_mesh()
    return () if mesh is None else tuple(
        a for a in ("pod", "data") if a in mesh.axis_names)


def data_axis(mesh=None):
    """The data axes as one ``gather_line`` axis: the one name, or the
    tuple ('pod', 'data')."""
    axes = data_axes(mesh)
    return axes[0] if len(axes) == 1 else axes


def data_lines(mesh=None) -> int:
    """How many data lines the mesh has: the product of its data axes."""
    mesh = mesh or current_mesh()
    return 1 if mesh is None else mesh.axis_size(data_axes(mesh))


def data_line(mesh=None) -> int:
    """This rank's data line: its row-major index over the data axes."""
    mesh = mesh or current_mesh()
    return 0 if mesh is None else mesh.axis_index(data_axes(mesh))


# ---------------------------------------------------------- param specs --

def _filter_spec(spec, shape, mesh) -> list:
    """The reference's filter: drop axes absent from the mesh or already
    used by an earlier dim, and any entry whose axes do not divide its
    dim."""
    axes = set(mesh.axis_names)
    used: set = set()
    out = []
    for dim, s in enumerate(spec):
        if s is None:
            out.append(None)
            continue
        names = (s,) if isinstance(s, str) else tuple(s)
        names = tuple(n for n in names if n in axes and n not in used)
        if not names:
            out.append(None)
            continue
        size = 1
        for n in names:
            size *= mesh.axis_size(n)
        if dim < len(shape) and shape[dim] % size != 0:
            out.append(None)
            continue
        used.update(names)
        out.append(names if len(names) > 1 else names[0])
    return out


# (path regex, spec template), first match wins, as the reference's:
# 'tp' = the tensor axis, 'fsdp' = the data axes (train mode only), None
# = whole.  Templates align to the trailing dims.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"shared/(wg_t|wu_t|wd_t|wg_q|wu_q|wd_q|wg_s|wu_s|wd_s)$",
     ("tp", "fsdp")),
    (r"moe/(wg_t|wu_t|wd_t)$", ("tp", None, "fsdp")),
    (r"(wg_t|wu_t|wd_t|sign_wg|wg_q|wu_q|wd_q|wg_s|wu_s|wd_s)$",
     ("tp", "fsdp")),
    (r"router$", (None, None)),
    (r"lora_a$", ("fsdp", None)),
    (r"lora_b", (None, "tp")),
    (r"(wq|wk|wv|up|w_if|in_proj|w)$", ("fsdp", "tp")),
    (r"(wo|out_proj|down|out)$", ("tp", "fsdp")),
    (r"(bq|bk|bv|b_if)$", ("tp",)),
    (r"table$", ("tp", "fsdp")),
    (r"(A_log|D|dt_bias)$", ("tp",)),
    (r"conv_w$", (None, "tp")),
    (r"conv_b$", ("tp",)),
    (r"r$", ("tp", None, None)),
    (r".*", None),
]


def param_spec(path: str, shape: tuple, mesh, mode: str = "serve") -> tuple:
    """One leaf's spec, the reference's ``param_spec(path, shape, mode,
    mesh)``: a tuple with an entry a dim: 'model', the data axes (one
    name, or a tuple of them) or None.  "serve" keeps weights whole over
    the data axes; "train" splits a weight's 'fsdp' dim over them."""
    if mode not in ("serve", "train"):
        raise ValueError(f"param_spec mode {mode!r}: serve or train")
    template = None
    for pat, tmpl in _PARAM_RULES:
        if re.search(pat, path):
            template = tmpl
            break
    if template is None or len(shape) == 0:
        return ()
    pad = len(shape) - len(template)
    if pad > 0:
        template = (None,) * pad + tuple(template)
    elif pad < 0:
        template = tuple(template[:len(shape)])
    tp = "model" if "model" in mesh.axis_names else None
    fsdp = (data_axes(mesh) or None) if mode == "train" else None
    resolved = [tp if t == "tp" else fsdp if t == "fsdp" else None
                for t in template[:len(shape)]]
    return tuple(_filter_spec(resolved, shape, mesh))


# ------------------------------------------------------------- the heads --

@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """This rank's attention heads: query heads [q0, q1) and KV heads
    [k0, k1) of the config's, the heads split over ``shards`` ranks (1:
    every rank keeps every head)."""
    q0: int
    q1: int
    k0: int
    k1: int
    shards: int


def attention_heads(n_heads: int, n_kv_heads: int, mesh=None) -> HeadSplit:
    """The heads a rank of ``mesh`` (None: the current mesh) keeps.  Query
    heads split into 'model'-axis-many contiguous runs when the axis
    divides them, else the attention stays whole.  KV heads split the same
    way when the axis divides them; else, when the KV head count divides
    the axis (MQA's 1 among them), a rank keeps the one KV head its run of
    query heads reads, which ranks then share; else the attention stays
    whole."""
    mesh = mesh or current_mesh()
    m = model_size(mesh)
    whole = HeadSplit(0, n_heads, 0, n_kv_heads, 1)
    if m == 1 or n_heads % m:
        return whole
    i = mesh.axis_index("model")
    q0, q1 = i * n_heads // m, (i + 1) * n_heads // m
    if kv_model_axis_entries(n_kv_heads, 0, mesh)[0] == "model":
        k0, k1 = i * n_kv_heads // m, (i + 1) * n_kv_heads // m
    elif m % n_kv_heads == 0:
        k0 = i // (m // n_kv_heads)
        k1 = k0 + 1
    else:
        return whole
    return HeadSplit(q0, q1, k0, k1, m)


def kv_model_axis_entries(k_heads: int, head_dim: int, mesh=None) -> tuple:
    """The ('K', 'hd') entries of a KV cache's spec: 'model' on the KV-head
    dim when the axis divides it, else none (the reference falls back to
    the head dim; a rank here keeps its query heads' KV head instead)."""
    m = model_size(mesh)
    return ("model", None) if m > 1 and k_heads % m == 0 else (None, None)


# ------------------------------------------------ combines over 'model' --

def gather_line(t: torch.Tensor, axis: str = "model",
                mesh=None) -> torch.Tensor:
    """(n, ...): ``t`` of every rank of this rank's line along ``axis`` of
    ``mesh`` (None: the current mesh), stacked in rank order."""
    mesh = mesh or current_mesh()
    group = mesh.group(axis)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def slot_range(batch: int, mesh=None) -> range:
    """The batch slots (or a training batch's rows) this rank's data line
    owns, the reference's ``slot_sharding`` as a range: line j of D holds
    slots [j*B/D, (j+1)*B/D), the contiguous blocks ``dp_shards`` splits
    the slots into.  Without a mesh, or with no data axis, every slot."""
    mesh = mesh or current_mesh()
    d = data_lines(mesh)
    if batch % d:
        raise ValueError(f"batch {batch} does not split over the mesh's "
                         f"{d} data lines")
    j = data_line(mesh)
    return range(j * batch // d, (j + 1) * batch // d)


def gather_slots(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """A (B/D, ...) tensor of every 'data' line, in line order along dim
    0: (B, ...), the same on every rank.  Without a 'data' axis, ``t``."""
    mesh = mesh or current_mesh()
    if data_lines(mesh) == 1:
        return t
    return gather_line(t, data_axis(mesh), mesh).flatten(0, 1)


def ordered_sum(t: torch.Tensor, axis="model", mesh=None) -> torch.Tensor:
    """``t`` of every rank of this rank's line along ``axis`` (an axis or
    a tuple of axes) summed in ascending rank order in float32, one add at
    a time (``runtime/distributed.py:_combine_gathered``'s order), cast
    back to ``t``'s dtype: the same bits on every rank of the line."""
    parts = gather_line(t, axis, mesh).float()
    total = parts[0]
    for s in range(1, parts.shape[0]):
        total = total + parts[s]
    return total.to(t.dtype)


class _LineSum(torch.autograd.Function):
    """``ordered_sum`` forward; the gradient passes through to the rank's
    part (every rank of the line uses the sum alike)."""

    @staticmethod
    def forward(ctx, t, axis, mesh):
        return ordered_sum(t, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Entry(torch.autograd.Function):
    """Identity forward; the gradient is the line's gradients summed in
    rank order (each rank's is the part through its own weights)."""

    @staticmethod
    def forward(ctx, t, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ordered_sum(g.contiguous(), ctx.axis, ctx.mesh), None, None


class _Concat(torch.autograd.Function):
    """The line's pieces concatenated along ``dim`` in rank order; the
    backward takes the rank's piece."""

    @staticmethod
    def forward(ctx, t, dim, mesh):
        parts = gather_line(t, "model", mesh)
        ctx.dim, ctx.n = dim % t.ndim, t.shape[dim]
        ctx.i = mesh.axis_index("model")
        return torch.cat(parts.unbind(0), dim=ctx.dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.i * ctx.n, ctx.n), None, None


def line_sum(t: torch.Tensor, axis="model", mesh=None) -> torch.Tensor:
    """``ordered_sum`` over ``axis`` whose gradient passes through to the
    rank's part: for a sum that every rank of the line then uses alike."""
    mesh = mesh or current_mesh()
    return _LineSum.apply(t, axis, mesh)


def model_sum(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """The 'model' line's partials summed in ascending rank order
    (``ordered_sum``); the gradient passes through to the rank's
    partial."""
    return line_sum(t, "model", mesh)


def model_entry(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """A replicated activation entering this rank's part of split weights
    (the QKV and gate/up projections, the head): ``t`` itself, whose
    gradient is the 'model' line's input gradients summed in rank
    order."""
    if not torch.is_grad_enabled():
        return t
    mesh = mesh or current_mesh()
    return _Entry.apply(t, "model", mesh)


def model_concat(t: torch.Tensor, mesh=None, dim: int = -1) -> torch.Tensor:
    """The 'model' line's pieces concatenated along ``dim`` in rank order;
    the backward takes the rank's piece."""
    mesh = mesh or current_mesh()
    return _Concat.apply(t, dim, mesh)
