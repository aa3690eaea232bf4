"""The port's rank meshes (``parallel/mesh.py``) against the JAX package's
device meshes (``lzma_sdk_zliblike_tpu/parallel/mesh.py``).

``normalize_axes`` must equal the JAX function on every input of the grid,
``make_mesh_2d`` must refuse what the JAX one refuses (8 CPU devices here,
as ``conftest.py`` sets them), and ``lane_shard`` must give each rank the
block of lanes that the JAX ``NamedSharding`` gives the device of the same
index.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import jax
from lzma_sdk_zliblike_tpu.parallel import mesh as JM
from lzma_sdk_zliblike_tpu_torch.parallel import mesh as M
from lzma_sdk_zliblike_tpu_torch.utils.errors import UnsupportedError

GRID = (None, -1, 0, 1, 2, 3, 63, 64, 65, 128)


def test_constants_equal_jax():
    assert (M.MAX_CHIP_AXIS, M.DEFAULT_LANES_PER_CHIP) == (
        JM.MAX_CHIP_AXIS, JM.DEFAULT_LANES_PER_CHIP) == (64, 64)


@pytest.mark.parametrize("per_chip", GRID)
def test_normalize_axes_equals_jax(per_chip):
    for chips, total in itertools.product(GRID, GRID):
        got = M.normalize_axes(per_chip, chips, total)
        assert got == JM.normalize_axes(per_chip, chips, total), \
            (per_chip, chips, total)
        assert got[1] <= M.MAX_CHIP_AXIS          # the clamp at 64
    for kw in ({"default_per_chip": 3}, {"max_chips": 5},
               {"default_per_chip": 128, "max_chips": 1}):
        for chips, total in itertools.product(GRID, GRID):
            assert M.normalize_axes(per_chip, chips, total, **kw) == \
                JM.normalize_axes(per_chip, chips, total, **kw)


def test_normalize_axes_clamps_chips_at_64():
    assert M.normalize_axes(1, 65, None) == (1, 64, 64)
    assert M.normalize_axes(None, None, 128 * 64) == (64, 64, 128 * 64)
    assert M.normalize_axes(1, None, 128) == (1, 64, 128)


@pytest.mark.parametrize("chips,per_chip",
                         [(1, 1), (2, 4), (4, 2), (8, 1), (3, 3), (1, 9),
                          (16, 1)])
def test_make_mesh_2d_raises_as_jax(chips, per_chip):
    world = len(jax.devices())
    assert world == 8
    try:
        jmesh = JM.make_mesh_2d(chips, per_chip)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            M.make_mesh_2d(chips, per_chip, world=world, rank=0)
        assert str(got.value) == str(e)
        return
    mesh = M.make_mesh_2d(chips, per_chip, world=world, rank=0)
    assert mesh.shape == tuple(jmesh.devices.shape)
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert mesh.size == chips * per_chip


def _jax_blocks(sharding, n):
    """Each device's block of an [n] array under ``sharding``, in the order
    of the mesh's flattened devices."""
    idx = sharding.devices_indices_map((n,))
    return [idx[d][0] for d in sharding.mesh.devices.flat]


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_lane_shard_equals_jax_sharding(world):
    n = 16
    jblocks = _jax_blocks(JM.lane_sharding(JM.make_mesh(world)), n)
    blocks = [M.lane_shard(n, world, r) for r in range(world)]
    assert [(b.start or 0, b.stop or n) for b in jblocks] == \
        [(b.start, b.stop) for b in blocks]
    # every lane exactly once
    hits = np.zeros(n, int)
    for b in blocks:
        hits[b] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("chips,per_chip", [(2, 2), (4, 2), (2, 4), (1, 8)])
def test_lane_shard_2d_is_the_flattened_product(chips, per_chip):
    n = 32
    jblocks = _jax_blocks(JM.lane_sharding_2d(JM.make_mesh_2d(chips,
                                                              per_chip)), n)
    for r, jb in enumerate(jblocks):
        mesh = M.make_mesh_2d(chips, per_chip, world=8, rank=r)
        b = mesh.lane_shard(n)
        assert (b.start, b.stop) == (jb.start or 0, jb.stop or n)


@pytest.mark.parametrize("n,world,rank", [(10, 4, 0), (7, 2, 1), (3, 4, 3),
                                          (8, 0, 0), (8, 2, 2), (8, 2, -1)])
def test_lane_shard_refuses_uneven_or_out_of_world(n, world, rank):
    with pytest.raises(ValueError):
        M.lane_shard(n, world, rank)


def test_mesh_without_process_group_is_one_rank():
    mesh = M.make_mesh()
    assert (mesh.shape, mesh.axis_names, mesh.rank) == ((1,), ("dp",), 0)
    assert M.make_mesh(4, rank=3).lane_shard(8) == slice(6, 8)


def test_local_device():
    assert M.local_device(3, "cpu") == torch.device("cpu")


def test_local_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(UnsupportedError):
        M.local_device(0, "cuda")
