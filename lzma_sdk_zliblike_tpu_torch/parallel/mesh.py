"""Rank meshes: how the lanes of a decode batch are dealt to processes.

The counterpart of the JAX package's ``parallel/mesh.py``.  There a
``jax.sharding.Mesh`` of devices partitions the lane axis of a batch with
``shard_map``; here each rank of a ``torch.distributed`` process group is one
device, every rank holds the whole batch, and ``lane_shard`` is the
contiguous block of lanes that ``shard_map`` would give it.  A 2-axis mesh
(chips x lanes per chip) shards over the flattened product, as the JAX
package's ``lane_sharding_2d`` does.

This module builds no process group: ``torch.distributed``'s own device mesh
would create NCCL groups, and NCCL refuses two ranks on one card, which is
how a one-card machine runs a cluster.  ``parallel/distributed.py`` sets up
the (Gloo) group.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

# -- 2-axis parallelism algebra (chips x lanes-per-chip) --------------------
#
# The reference factorizes totalThreads = lzmaThreads x blockThreads
# (Lzma2EncProps_Normalize, Lzma2Enc.c:176-221); chips (the block-parallel
# dp axis) x lanes per chip solve the same t1*t2=t3 system with the same
# precedence.

MAX_CHIP_AXIS = 64            # dp-axis bound (MtCoder ring bound analog)
DEFAULT_LANES_PER_CHIP = 64   # kernel lane batch when unspecified


def normalize_axes(per_chip: int | None, chips: int | None,
                   total: int | None, *,
                   default_per_chip: int = DEFAULT_LANES_PER_CHIP,
                   max_chips: int = MAX_CHIP_AXIS) -> tuple[int, int, int]:
    """Resolve (lanes_per_chip, chips, total_lanes) with t1*t2=t3.

    Mirrors ``Lzma2EncProps_Normalize`` (``Lzma2Enc.c:176-221``): -1/None
    means "derive me"; a fully specified pair wins over ``total``.
    """
    t1 = per_chip if per_chip and per_chip > 0 else 0
    t2 = chips if chips and chips > 0 else 0
    t3 = total if total and total > 0 else 0
    t1n = t1 if t1 > 0 else default_per_chip
    if t2 > max_chips:
        t2 = max_chips
    if t3 <= 0:
        if t2 <= 0:
            t2 = 1
        t3 = t1n * t2
    elif t2 <= 0:
        t2 = t3 // t1n
        if t2 == 0:
            t1 = 1
            t2 = t3
        if t2 > max_chips:
            t2 = max_chips
    elif t1 <= 0:
        t1 = t3 // t2
        if t1 == 0:
            t1 = 1
    else:
        t3 = t1n * t2
    if t1 <= 0:
        t1 = t1n
    return t1, t2, t3


def lane_shard(n_lanes: int, world: int, rank: int) -> slice:
    """The contiguous block of ``n_lanes`` lanes that rank ``rank`` of
    ``world`` decodes, as ``shard_map`` partitions the lane axis.  Raises
    ValueError unless the lanes split evenly and the rank is in the world."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    if n_lanes % world:
        raise ValueError(f"{n_lanes} lanes do not split over {world} ranks")
    per = n_lanes // world
    return slice(rank * per, (rank + 1) * per)


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """The ranks of a process group as a device mesh: ``shape`` over
    ``axis_names``, and this process's ``rank`` in its flattened order."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    rank: int

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def lane_shard(self, n_lanes: int) -> slice:
        """This rank's lanes, over the flattened product of the axes."""
        return lane_shard(n_lanes, self.size, self.rank)


def world_and_rank() -> tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(world: int | None = None, *, rank: int | None = None,
              axis: str = "dp") -> RankMesh:
    """A 1-axis mesh of ``world`` ranks (default: the process group's)."""
    w, r = world_and_rank()
    return RankMesh((w if world is None else world,), (axis,),
                    r if rank is None else rank)


def make_mesh_2d(chips: int, per_chip: int, *, world: int | None = None,
                 rank: int | None = None,
                 axes: tuple[str, str] = ("dp", "lane")) -> RankMesh:
    """Two-axis mesh: [chips, per_chip] ranks of the first chips x per_chip;
    lane arrays partition on the flattened product.  Raises ValueError when
    the world has fewer ranks than that."""
    w, r = world_and_rank()
    world = w if world is None else world
    need = chips * per_chip
    if world < need:
        raise ValueError(f"need {need} devices, have {world}")
    return RankMesh((chips, per_chip), tuple(axes), r if rank is None else rank)


def local_device(rank: int, device="cuda") -> torch.device:
    """The device rank ``rank`` runs on: ``cuda:{LOCAL_RANK}`` (or ``rank``
    modulo the cards this machine has) for ``"cuda"``, the CPU for
    ``"cpu"``; a card named by its index stays as named.  Ranks beyond the
    card count share cards."""
    from ..api import check_device
    device = check_device(device)
    if device.type == "cpu" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())
