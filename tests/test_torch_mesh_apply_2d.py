"""The 2x2 and 1x2 placements of ``tests/test_torch_mesh_apply.py``: the
grid (4, 4) on a 2x2 mesh of gloo ranks, where each rank loops over 2 x 2
tiles, and (1, 2) on 1x2; every case bitwise the one-process
``emulated_apply`` and within the parity contract of the JAX package's
``shard_map_apply`` on a host-device mesh of the same shape."""
import pytest

from test_torch_mesh_apply import (IDS, check_bitwise_emulated,
                                   check_matches_reference)


@pytest.mark.parametrize("i", [2, 3], ids=IDS[2:])
def test_shard_map_apply_bitwise_emulated(i):
    check_bitwise_emulated(i)


@pytest.mark.parametrize("i", [2, 3], ids=IDS[2:])
def test_shard_map_apply_matches_reference(i):
    check_matches_reference(i)
