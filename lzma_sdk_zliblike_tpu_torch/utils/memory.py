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

An encode batch (kernel K2) holds each lane's op words, chunk table, body
buffer and the kernel's scratch (the coder's stream and a body slot per
chunk, ``ops/range_encode.scratch_lane_bytes``); ``encode_lanes`` sizes it
by the same budget, with the same ``INFLIGHT``.

A decode's host result is one ``bytes`` object, made uninitialised at its
final size and filled in place before the caller sees it
(``result_bytes``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .trace import TRACE

INFLIGHT = 2                 # batches on the device at once
CPU_BUDGET = 8 << 30         # bytes, when no card is involved


_new_bytes = ctypes.pythonapi.PyBytes_FromStringAndSize
_new_bytes.restype = ctypes.py_object
_new_bytes.argtypes = (ctypes.c_void_p, ctypes.c_ssize_t)
_bytes_data = ctypes.pythonapi.PyBytes_AsString
_bytes_data.restype = ctypes.c_void_p
_bytes_data.argtypes = (ctypes.py_object,)


class _Writable:
    """A numpy view's owner: ``n`` bytes at ``address``, kept alive by
    ``owner``."""

    def __init__(self, owner, address: int, n: int):
        self.owner = owner
        self.__array_interface__ = {"data": (address, False), "shape": (n,),
                                    "typestr": "|u1", "version": 3}


def result_bytes(n: int) -> tuple[bytes, np.ndarray]:
    """A new, uninitialised ``bytes`` of ``n`` bytes (as the stdlib's
    ``zlib`` and ``lzma`` make their results) and a writable uint8 view of
    it, which keeps it alive.  Fill the whole view before the ``bytes``
    reaches anything else, and drop the view once it is filled."""
    if n < 0:
        raise ValueError(f"a result of {n} bytes")
    out = _new_bytes(None, n)
    if n == 0:      # the shared empty bytes: nothing to write
        return out, np.empty(0, np.uint8)
    return out, np.asarray(_Writable(out, _bytes_data(out), n))


def device_budget(device) -> int:
    """Bytes a decode or encode may hold on ``device`` (env override
    LZT_HBM_BUDGET)."""
    with TRACE.span("memory.device_budget"):
        env = os.environ.get("LZT_HBM_BUDGET")
        if env:
            return int(env)
        device = torch.device(device)
        if device.type == "cuda":
            return torch.cuda.mem_get_info(device)[0]
        return CPU_BUDGET


def decode_batch_hbm_bytes(n_lanes: int, pack_cap: int, dic_cap: int,
                           inflight: int = INFLIGHT) -> int:
    """Device bytes ``inflight`` batches of ``n_lanes`` one-group lanes hold.

    The output (the dictionary) is ``dic_cap`` bytes per lane; the packed
    source adds ``pack_cap`` per lane.  Status and chunk tables are small
    and ignored."""
    return n_lanes * (dic_cap + pack_cap) * inflight


def pick_lanes(pack_cap: int, dic_cap: int, *, hbm_budget: int,
               max_lanes: int | None = None, min_lanes: int = 1,
               inflight: int = INFLIGHT) -> int:
    """Most one-group lanes whose ``inflight`` batches fit the budget, at
    most ``max_lanes`` (None: no cap) and at least ``min_lanes``.

    Any count, where the JAX package's is the largest power of two: K1 runs
    one lane per block, so a lane more is a group more at once."""
    lanes = hbm_budget // decode_batch_hbm_bytes(1, pack_cap, dic_cap,
                                                 inflight)
    if max_lanes is not None:
        lanes = min(lanes, max_lanes)
    return max(min_lanes, lanes)


def _round4k(n: int) -> int:
    return -(-n // 4096) * 4096


def fits_launcher(group) -> bool:
    """Whether K1's launcher takes a lane of this one group: its packed and
    unpacked sizes, 4 KiB-rounded as the batch shape rounds them, stay below
    ``ops/group_decode.CAP_LIMIT``.  Larger groups decode on the host."""
    from ..ops.group_decode import CAP_LIMIT
    return (_round4k(sum(c.pack_size for c in group)) < CAP_LIMIT
            and _round4k(sum(c.unpack_size for c in group)) < CAP_LIMIT)


def shape_for_groups(groups, *, device="cuda", hbm_budget: int | None = None,
                     max_lanes: int | None = None):
    """A BatchShape sized to the stream's groups under the device budget.

    dic_cap/pack_cap cover the largest group the launcher takes
    (``fits_launcher``; 4 KiB-rounded): a group that must go to the host
    does not size every lane.  The lane count is the number of those groups
    that hold an LZMA chunk, capped by the budget and by ``max_lanes``
    (None: no cap), with one group per lane.  The shape carries no
    (lc, lp, pb): the scheduler gives each its own launch."""
    from ..parallel.scheduler import BatchShape

    with TRACE.span("memory.shape_for_groups"):
        groups = [g for g in groups if fits_launcher(g)]
        dic_cap = _round4k(max((sum(c.unpack_size for c in g)
                                for g in groups), default=1 << 16))
        pack_cap = _round4k(max((sum(c.pack_size for c in g)
                                 for g in groups), default=1 << 16))
        n_lzma = sum(1 for g in groups if any(c.is_lzma for c in g))
        if hbm_budget is None:
            hbm_budget = device_budget(device)
        lanes = min(max(1, n_lzma),
                    pick_lanes(pack_cap, dic_cap, hbm_budget=hbm_budget,
                               max_lanes=max_lanes))
        return BatchShape(n_lanes=lanes, pack_cap=pack_cap, dic_cap=dic_cap,
                          groups_per_lane=1)


def encode_batch_bytes(n_lanes: int, op_cap: int, out_cap: int,
                       n_chunks: int) -> int:
    """Device bytes ``INFLIGHT`` encode batches of ``n_lanes`` lanes hold.

    A lane holds ``op_cap`` int32 op words (rounded up as ``pack_ops_batch``
    rounds its rows), ``n_chunks`` int32 chunk ends and tab entries,
    ``out_cap`` body bytes, its active flag and 4 status words, and the
    kernel's scratch."""
    from ..ops.range_encode import op_row_words, scratch_lane_bytes
    op_cap = op_row_words(op_cap)
    lane = (4 * op_cap + 8 * n_chunks + out_cap + 4 * (1 + 4)
            + scratch_lane_bytes(op_cap, n_chunks))
    return n_lanes * lane * INFLIGHT


def encode_lanes(n_groups: int, op_cap: int, out_cap: int, n_chunks: int, *,
                 device="cuda", hbm_budget: int | None = None) -> int:
    """Lanes of an encode batch: one per group, capped by the budget (at
    least 1)."""
    if hbm_budget is None:
        hbm_budget = device_budget(device)
    return max(1, min(n_groups, hbm_budget // encode_batch_bytes(
        1, op_cap, out_cap, n_chunks)))
