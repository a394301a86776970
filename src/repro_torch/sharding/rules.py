"""The mesh context of the placed sparse decode: the counterpart of
``repro/sharding/rules.py:33-90``.

``use_mesh`` makes a ``launch.mesh.RankMesh`` the current mesh of this
process; the sparse MLP's dispatch (``runtime/distributed.py:
sharded_apply``) and the dense MLP (``layers/mlp.py``) read it.  Inside
``shard_local`` every helper sees no mesh: the tile loop of
``shard_map_apply`` works on a rank's own values.  The reference's
``mesh_axes`` and ``axis_size`` are ``RankMesh.axis_names`` and
``RankMesh.axis_size`` here; its ``tp_axis`` is always 'model' and its
``data_axes`` 'data', the only axes a ``RankMesh`` has.  The reference's
partition-spec rules for GSPMD (``rules.py:91-304``) are not ported
(ROADMAP Queue A item 15).
"""
from __future__ import annotations

import contextlib
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

