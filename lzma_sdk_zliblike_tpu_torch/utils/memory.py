"""Device-memory budget for decode and encode batches.

A decode batch holds its whole group output (the dictionary) plus the packed
source per lane on the card, and the scheduler keeps ``INFLIGHT`` batches
there at once (one decoding while the host assembles the next).  At the
reference's default MT block of 4 x dict = 64 MiB (``Lzma2Enc.c:223-233``)
a careless batch would ask for many GiB, so ``shape_for_groups`` sizes the
lane count to a budget:

* on the card, the free memory ``torch.cuda.mem_get_info()`` reports;
* ``LZT_HBM_BUDGET`` (bytes) overrides it, as in the JAX package;
* on the CPU (the plain version), ``LZT_HBM_BUDGET`` or 8 GiB.

The kernel runs one thread per lane, so unlike the TPU kernel it wants as
many lanes as there are groups, one group each: more lanes beat longer
lanes.  The lane count is the number of groups, capped by the budget; a
stream whose groups do not fit is decoded in several batches.

An encode batch (kernel K2) holds each lane's op words and its body buffer;
``encode_lanes`` sizes it by the same budget, with the same ``INFLIGHT``.
"""

from __future__ import annotations

import os

import torch

INFLIGHT = 2                 # batches on the device at once
CPU_BUDGET = 8 << 30         # bytes, when no card is involved


def device_budget(device) -> int:
    """Bytes a decode or encode may hold on ``device`` (env override
    LZT_HBM_BUDGET)."""
    env = os.environ.get("LZT_HBM_BUDGET")
    if env:
        return int(env)
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return CPU_BUDGET


def decode_batch_hbm_bytes(n_lanes: int, pack_cap: int, dic_cap: int) -> int:
    """Device bytes ``INFLIGHT`` batches of ``n_lanes`` one-group lanes hold.

    The output (the dictionary) is ``dic_cap`` bytes per lane; the packed
    source adds ``pack_cap`` per lane.  Status and chunk tables are small
    and ignored."""
    return n_lanes * (dic_cap + pack_cap) * INFLIGHT


def pick_lanes(pack_cap: int, dic_cap: int, *, hbm_budget: int) -> int:
    """Most one-group lanes whose batches fit the budget (at least 1)."""
    return max(1, hbm_budget // decode_batch_hbm_bytes(1, pack_cap, dic_cap))


def shape_for_groups(groups, *, device="cuda", hbm_budget: int | None = None):
    """A BatchShape sized to the stream's groups under the device budget.

    dic_cap/pack_cap cover the largest group (4 KiB-rounded); the lane count
    is the number of groups that hold an LZMA chunk, capped by the budget,
    with one group per lane."""
    from ..parallel.scheduler import BatchShape

    dic_cap = max((sum(c.unpack_size for c in g) for g in groups),
                  default=1 << 16)
    dic_cap = -(-dic_cap // 4096) * 4096
    pack_cap = max((sum(c.pack_size for c in g) for g in groups),
                   default=1 << 16)
    pack_cap = -(-pack_cap // 4096) * 4096
    n_lzma = sum(1 for g in groups if any(c.is_lzma for c in g))
    if hbm_budget is None:
        hbm_budget = device_budget(device)
    lanes = min(max(1, n_lzma),
                pick_lanes(pack_cap, dic_cap, hbm_budget=hbm_budget))
    return BatchShape(n_lanes=lanes, pack_cap=pack_cap, dic_cap=dic_cap,
                      groups_per_lane=1)


def encode_batch_bytes(n_lanes: int, op_cap: int, out_cap: int) -> int:
    """Device bytes ``INFLIGHT`` encode batches of ``n_lanes`` lanes hold.

    A lane holds ``op_cap`` int32 op words and ``out_cap`` body bytes; the
    chunk tables and status are small and ignored."""
    return n_lanes * (4 * op_cap + out_cap) * INFLIGHT


def encode_lanes(n_groups: int, op_cap: int, out_cap: int, *, device="cuda",
                 hbm_budget: int | None = None) -> int:
    """Lanes of an encode batch: one per group, capped by the budget (at
    least 1)."""
    if hbm_budget is None:
        hbm_budget = device_budget(device)
    return max(1, min(n_groups, hbm_budget
                      // encode_batch_bytes(1, op_cap, out_cap)))
