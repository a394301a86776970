"""The card's constants for the dry run and the roofline, and the rank mesh
of the placed sparse decode: the counterparts of ``repro/launch/mesh.py``.

One NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit, from NVIDIA's
data sheet; a card set below 700 W runs slower under load.

``make_mesh`` lays a ``(data, model)`` grid over the ``torch.distributed``
ranks of an initialised process group, row-major as ``jax.make_mesh`` lays
devices (rank = data index * model size + model index), with one process
group per line of ranks along each axis.  ``launch/ranks.py`` starts the
ranks.  There is no ``make_production_mesh`` (ROADMAP Queue A item 15).
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

MESH_AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A grid of ranks: ``axis_names`` (a subsequence of ``MESH_AXES``) of
    sizes ``shape``.  ``rank`` is this process's rank (None: the grid's
    shape alone, made with no process group: what the grid checks read);
    ``groups`` maps each axis longer than 1 to the process group of this
    rank's line along it; ``host_group`` carries host tensors (None: the
    default group, gloo)."""

    axis_names: tuple
    shape: tuple
    rank: Optional[int] = None
    groups: dict = dataclasses.field(default_factory=dict)
    host_group: object = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return dict(zip(self.axis_names, self.shape)).get(name, 1)

    def coords(self) -> dict:
        """This rank's index along each axis."""
        if self.rank is None:
            raise ValueError("a mesh made without a process group has no "
                             "rank")
        return {name: int(i) for name, i in zip(
            self.axis_names, np.unravel_index(self.rank, self.shape))}

    def axis_index(self, name: str) -> int:
        """This rank's index along ``name`` (0 for an absent axis)."""
        return self.coords().get(name, 0)

    def group(self, name: str):
        """This rank's process group along ``name`` (an axis of one rank
        has none: it needs no collective)."""
        return self.groups[name]


def make_mesh(shape: tuple, axes: tuple) -> RankMesh:
    """A ``RankMesh`` of ``shape`` over ``axes`` (``("model",)``,
    ``("data",)`` or ``("data", "model")``).  With an initialised process
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
    host = (None if dist.get_backend() == "gloo"
            else dist.new_group(backend="gloo"))
    return RankMesh(axes, shape, rank, groups, host)
