"""The card's constants for the dry run and the roofline, and the rank mesh
of the placed sparse decode: the counterparts of ``repro/launch/mesh.py``.

One NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit, from NVIDIA's
data sheet; a card set below 700 W runs slower under load.

``make_mesh`` lays a grid over the ``torch.distributed`` ranks of an
initialised process group, row-major as ``jax.make_mesh`` lays devices
(on ``(data, model)``: rank = data index * model size + model index), with
one process group per line of ranks along each axis.  Its axes are a
subsequence of ``MESH_AXES``: ``(data, model)`` for serving and training,
``(pod, data, model)`` for a training mesh whose data lines are the
``(pod, data)`` pairs (``rules.data_axes``), ``(pipe,)`` for the GPipe module
(``sharding/pipeline.py``).  ``launch/ranks.py`` starts the ranks.  There
is no ``make_production_mesh`` (ROADMAP Queue A item 15).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch.distributed as dist

# HBM3 bandwidth of one H100 80GB SXM5 (700 W), bytes/s
HBM_BW = 3.35e12
# dense bfloat16 tensor-core peak of one H100 SXM5 (700 W), FLOP/s
PEAK_FLOPS_BF16 = 989e12
# device memory of one H100 80GB HBM3: 81559 MiB, as nvidia-smi reports it
HBM_PER_CARD = 81559 * 2**20

MESH_AXES = ("pipe", "pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A grid of ranks: ``axis_names`` (a subsequence of ``MESH_AXES``) of
    sizes ``shape``.  ``rank`` is this process's rank (None: the grid's
    shape alone, made with no process group: what the grid checks read);
    ``groups`` maps each axis longer than 1 to the process group of this
    rank's line along it (and the tuple of the data axes, where a mesh has
    more than one, to the group of the line they span); ``host_group``
    carries host tensors (None: the default group, gloo)."""

    axis_names: tuple
    shape: tuple
    rank: Optional[int] = None
    groups: dict = dataclasses.field(default_factory=dict)
    host_group: object = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name) -> int:
        """The axis's size (a tuple of axes: the product of theirs); 1 for
        an axis the mesh does not have."""
        if isinstance(name, tuple):
            return math.prod(self.axis_size(n) for n in name)
        return dict(zip(self.axis_names, self.shape)).get(name, 1)

    def coords(self) -> dict:
        """This rank's index along each axis."""
        if self.rank is None:
            raise ValueError("a mesh made without a process group has no "
                             "rank")
        return {name: int(i) for name, i in zip(
            self.axis_names, np.unravel_index(self.rank, self.shape))}

    def axis_index(self, name) -> int:
        """This rank's index along ``name`` (0 for an absent axis; a tuple
        of axes: the row-major index over them)."""
        if isinstance(name, tuple):
            idx = 0
            for n in name:
                idx = idx * self.axis_size(n) + self.axis_index(n)
            return idx
        return self.coords().get(name, 0)

    def group(self, name):
        """This rank's process group along ``name`` (an axis, or a tuple
        of axes; a line of one rank has none: it needs no collective)."""
        if isinstance(name, tuple) and len(name) == 1:
            name = name[0]
        return self.groups[name]

    def with_rank(self, rank: int) -> "RankMesh":
        """The same grid seen from ``rank``, without process groups: what
        a rank's placement would be, for any rank."""
        return RankMesh(self.axis_names, self.shape, rank)


def make_mesh(shape: tuple, axes: tuple) -> RankMesh:
    """A ``RankMesh`` of ``shape`` over ``axes``, a subsequence of
    ``MESH_AXES`` (``("model",)``, ``("data", "model")``, ``("pod",
    "data", "model")``, ``("pipe",)``, ...).  With an initialised process
    group its size must be the world size, and every rank must call this
    (each line's group is made by all ranks in the same order); without
    one it describes the grid only."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    order = [MESH_AXES.index(a) for a in axes if a in MESH_AXES]
    if (len(shape) != len(axes) or len(order) != len(axes) or not axes
            or order != sorted(set(order)) or min(shape) < 1):
        raise ValueError(
            f"mesh shape {shape} over axes {axes}: want one size >= 1 an "
            f"axis, the axes a subsequence of {MESH_AXES}")
    if not (dist.is_available() and dist.is_initialized()):
        return RankMesh(axes, shape)
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank()
    grid = np.arange(world).reshape(shape)
    groups = {}
    for ax, name in enumerate(axes):
        if shape[ax] == 1:
            continue
        # the lines along this axis, every rank making every line's group
        for line in np.moveaxis(grid, ax, -1).reshape(-1, shape[ax]).tolist():
            g = dist.new_group(line)
            if rank in line:
                groups[name] = g
    # the lines the data axes span together ('pod' then 'data')
    span = tuple(i for i, a in enumerate(axes) if a in ("pod", "data"))
    if len(span) > 1 and math.prod(shape[i] for i in span) > 1:
        n = math.prod(shape[i] for i in span)
        for line in np.moveaxis(grid, span, tuple(range(-len(span), 0))).reshape(
                -1, n).tolist():
            g = dist.new_group(line)
            if rank in line:
                groups[tuple(axes[i] for i in span)] = g
    host = (None if dist.get_backend() == "gloo"
            else dist.new_group(backend="gloo"))
    return RankMesh(axes, shape, rank, groups, host)
