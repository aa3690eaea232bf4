"""Chunk scheduler: maps LZMA2 streams onto lanes of the group-decode kernel.

The reference's MtCoder splits work into blocks decoded by a ring of threads
with token passing for ordered output (``MtCoder.c:185-224``).  Here
dict-reset *groups* are gathered into batches, every lane of the CUDA kernel
decodes one or more whole groups, and the ordered write ring becomes one
result buffer in which each group is written at its offset, the prefix sum
of the groups' unpacked sizes (``decode_into``).

Eligibility: a group runs on the device when all its LZMA chunks share one
(lc, lp, pb) with lc + lp <= 4, its copy chunks are well formed, a state
reset follows every copy chunk, it fits the batch's shape and the kernel's
launcher takes it (``utils/memory.fits_launcher``: below 2 GiB packed and
unpacked).  Groups of different props go to separate launches.  There is no
cap on the number of chunks in a group: the kernel's chunk table has none.
Copy-only groups are a plain memcpy; anything else is decoded on the host by
the native decoder (``scheduler.host_fallback_groups``).

``submit_batch`` / ``finalize_batch`` are the per-batch pair of the hybrid
engine (``parallel/hybrid.py``): one group per lane, each group's bytes back
or None where its lane failed.

``decode_into`` takes groups that may come from several streams of one
buffer (the 7z device route hands it every LZMA2 folder of an archive,
each chunk's offset into the archive) and, per group, a function that
rewrites the group's bytes in its K1 row before they are copied out (the
route's x86 BCJ on the card).
"""

from __future__ import annotations

import collections
import dataclasses
import heapq

import numpy as np
import torch

from ..models.lzma2 import framing
from ..ops import group_decode as G
from ..utils.errors import DataError
from ..utils.memory import INFLIGHT, fits_launcher, result_bytes
from ..utils.trace import TRACE
from .host_pool import decode_group_native

# The dict prop of the host fallback: the largest dictionary, so that, as on
# the card, a match is checked against the group's own output alone.
_HOST_DICT_PROP = 40


@dataclasses.dataclass(frozen=True)
class BatchShape:
    """Shapes of one decode batch."""

    n_lanes: int = 256
    pack_cap: int = 1 << 16          # per-group packed bytes
    dic_cap: int = 1 << 18           # per-group unpacked bytes
    groups_per_lane: int = 4         # most groups one lane decodes in turn


def _packed(group) -> int:
    return sum(c.pack_size for c in group)


def _unpacked(group) -> int:
    return sum(c.unpack_size for c in group)


class BatchedLzma2Decoder:
    """Decodes LZMA2 streams through the group-decode kernel (K1).

    ``device="cuda"`` launches the CUDA kernel; ``device="cpu"`` runs its
    plain PyTorch version.  Each lane decodes whole groups (all chunks, with
    state carry, per-chunk range-coder and state resets, copy chunks);
    when there are more eligible groups than lanes, up to
    ``groups_per_lane`` groups share a lane back to back (flags bit3).  At
    most ``INFLIGHT`` batches are on the device at once."""

    def __init__(self, shape: BatchShape = BatchShape(), device="cuda"):
        self.shape = shape
        self.device = torch.device(device)

    # -- group eligibility --------------------------------------------------
    def _eligible(self, group: list[framing.Chunk]):
        """The (lc, lp, pb) the group decodes with on the card, or None."""
        s = self.shape
        if _unpacked(group) > s.dic_cap or _packed(group) > s.pack_cap \
                or not fits_launcher(group):
            return None
        props = None
        need_reset = True   # fresh kernel probs need a reset chunk
        for c in group:
            if not c.is_lzma:
                if c.pack_size != c.unpack_size:
                    return None
                need_reset = True
                continue
            if need_reset and c.mode < framing.MODE_STATE:
                return None
            if c.props is not None:
                p = (c.props.lc, c.props.lp, c.props.pb)
                if props not in (None, p):
                    return None     # props change inside the group
                props = p
            need_reset = False
        if props is None or props[0] + props[1] > 4:
            return None     # LZMA2 forbids lc + lp > 4; the host reports it
        return props

    def decode(self, stream: bytes, dict_prop: int) -> bytes:
        framing.decode_dict_prop(dict_prop)  # validate
        chunks, _ = framing.scan(stream)
        groups = framing.split_groups(chunks)
        out, view = result_bytes(sum(_unpacked(g) for g in groups))
        self.decode_into(stream, groups, view)
        return out

    def decode_groups(self, stream: bytes,
                      groups: list[list[framing.Chunk]]) -> list[bytes]:
        """Decode dict-reset groups: each group's bytes, in order."""
        out, view = result_bytes(sum(_unpacked(g) for g in groups))
        self.decode_into(stream, groups, view)
        ends = np.cumsum([0] + [_unpacked(g) for g in groups]).tolist()
        return [out[a:b] for a, b in zip(ends[:-1], ends[1:])]

    def decode_into(self, stream: bytes, groups: list[list[framing.Chunk]],
                    result: np.ndarray, *, convert=None) -> set[int]:
        """Decode dict-reset groups into ``result`` (writable uint8, their
        unpacked size in all), each group at the prefix sum of the sizes
        before it: a card's group from its lane's row, a copy-only group
        from the stream's bytes, another group from the host decoder's.  No
        group's bytes become an object of their own on the way.

        ``convert`` maps a group index to a function that rewrites that
        group's bytes where K1 left them, before they are copied out: it is
        called with the ``[1, n]`` uint8 slice of the lane's row (on the
        card, or the plain version's CPU row) and changes it in place.
        Returns the groups so converted; a group decoded anywhere else (a
        copy-only or host group) comes back as it decoded, for the caller
        to convert."""
        convert = convert or {}
        converted: set[int] = set()
        offs = np.cumsum([0] + [_unpacked(g) for g in groups]).tolist()
        if len(result) != offs[-1]:
            raise ValueError(f"a result of {len(result)} bytes for groups "
                             f"of {offs[-1]}")
        with TRACE.span("scheduler.route"):
            copies, natives, by_props = self._sort(groups)
            decoded = []
            for gi in natives:
                TRACE.add("scheduler.host_fallback_groups")
                decoded.append((gi, decode_group_native(
                    stream, groups[gi], _HOST_DICT_PROP)))
        if decoded or copies:
            with TRACE.span("scheduler.outputs"):
                src = np.frombuffer(stream, np.uint8)
                for gi in copies:
                    at = offs[gi]
                    for c in groups[gi]:
                        result[at:at + c.pack_size] = \
                            src[c.data_off:c.data_off + c.pack_size]
                        at += c.pack_size
                for gi, part in decoded:
                    result[offs[gi]:offs[gi + 1]] = np.frombuffer(part,
                                                                  np.uint8)
                del decoded
        for props, idx in by_props.items():
            self._decode_on_device(stream, groups, idx, props,
                                   self._multi_k(len(idx)), offs, result,
                                   convert, converted)
        return converted

    def _sort(self, groups: list[list[framing.Chunk]]):
        """``(copies, natives, by_props)``: the copy-only groups, the
        groups the card cannot take, and the card's groups per (lc, lp,
        pb), each in group order."""
        copies: list[int] = []
        natives: list[int] = []
        by_props: dict[tuple[int, int, int], list[int]] = {}
        for gi, g in enumerate(groups):
            if all(not c.is_lzma for c in g):
                copies.append(gi)
            elif (props := self._eligible(g)) is not None:
                by_props.setdefault(props, []).append(gi)
            else:
                natives.append(gi)
        return copies, natives, by_props

    def route(self, stream: bytes, groups: list[list[framing.Chunk]], *,
              host: bool = True):
        """Sort groups by where they decode: ``(results, by_props)``.

        Copy-only groups are copied and the groups the card cannot take
        are decoded by the native host decoder into ``results`` (list by
        group index, None elsewhere); with ``host=False`` both are left to
        another process and stay None.  ``by_props`` lists the indices of
        the card's groups per (lc, lp, pb), in group order."""
        results: list[bytes | None] = [None] * len(groups)
        copies, natives, by_props = self._sort(groups)
        if host:
            for gi in copies:
                results[gi] = b"".join(
                    stream[c.data_off:c.data_off + c.pack_size]
                    for c in groups[gi])
            for gi in natives:
                TRACE.add("scheduler.host_fallback_groups")
                results[gi] = decode_group_native(stream, groups[gi],
                                                  _HOST_DICT_PROP)
        return results, by_props

    def _multi_k(self, n_groups: int) -> int:
        """Groups per lane: 1 while every group has a lane of its own, and
        never so many that a lane's row reaches the launcher's limit."""
        s = self.shape
        return max(1, min(s.groups_per_lane, -(-n_groups // s.n_lanes),
                          (G.CAP_LIMIT - 1) // max(s.pack_cap, s.dic_cap)))

    def _decode_on_device(self, stream, groups, idx, props, k: int, offs,
                          result, convert, converted):
        """Decode groups ``idx`` of one (lc, lp, pb) into ``result`` at
        ``offs`` in batches of lanes of up to k groups, keeping at most
        INFLIGHT batches on the device: the card decodes one batch while
        the host assembles the next.  ``convert`` and ``converted`` are
        ``decode_into``'s."""
        pending: collections.deque = collections.deque()
        again: list[int] = []
        for lanes in self._pack_lanes(groups, idx, k):
            if len(pending) == INFLIGHT:
                again += self._finalize(*pending.popleft(), groups, stream,
                                        offs, result, convert, converted)
            TRACE.add("scheduler.pallas_multi_batches" if k > 1
                      else "scheduler.pallas_batches")
            with TRACE.span("scheduler.assemble"):
                arrays = self._assemble(stream, [[groups[gi] for gi in lane]
                                                 for lane in lanes], k)
            handle = self._submit(*arrays, dic_cap=k * self.shape.dic_cap,
                                  props=props)
            pending.append((handle, lanes, k))
        while pending:
            again += self._finalize(*pending.popleft(), groups, stream, offs,
                                    result, convert, converted)
        if again:   # groups of failed multi-group lanes: one per lane now
            self._decode_on_device(stream, groups, again, props, 1, offs,
                                   result, convert, converted)

    def _pack_lanes(self, groups, idx, k: int):
        """Batches of lanes, each lane a list of group indices within
        k x (pack_cap, dic_cap) bytes; the largest group goes first, to the
        least-loaded lane.  Empty lanes are left out."""
        s = self.shape
        cap_p, cap_u = k * s.pack_cap, k * s.dic_cap
        remaining = sorted(idx, key=lambda gi: -_packed(groups[gi]))
        while remaining:
            take, remaining = (remaining[:k * s.n_lanes],
                               remaining[k * s.n_lanes:])
            lanes: list[list[int]] = [[] for _ in range(s.n_lanes)]
            load = [(0, 0, li) for li in range(s.n_lanes)]  # packed, unpacked
            spill = []
            for gi in take:
                p, u = _packed(groups[gi]), _unpacked(groups[gi])
                lane_p, lane_u, li = load[0]
                if lane_p + p <= cap_p and lane_u + u <= cap_u:
                    heapq.heapreplace(load, (lane_p + p, lane_u + u, li))
                    lanes[li].append(gi)
                else:                    # rare bin-packing overflow
                    spill.append(gi)
            remaining = spill + remaining
            yield [lane for lane in lanes if lane]

    def _assemble(self, stream, lane_lists, k: int):
        """Host arrays of one batch: each lane holds a list of dict-reset
        groups back to back; every group's first chunk after the first
        carries flags bit1|bit3 (state reset + dict rebase)."""
        s = self.shape
        n = len(lane_lists)
        n_chunks = max(1, max((sum(len(g) for g in lg) for lg in lane_lists),
                              default=1))
        src = np.zeros((n, k * s.pack_cap), np.uint8)
        pe = np.zeros((n, n_chunks), np.int32)
        ue = np.zeros((n, n_chunks), np.int32)
        fl = np.zeros((n, n_chunks), np.int32)
        act = np.zeros(n, np.int32)
        for li, lg in enumerate(lane_lists):
            if not lg:
                continue
            acc_p = acc_u = 0
            j = 0
            for gi2, g in enumerate(lg):
                for ci, c in enumerate(g):
                    src[li, acc_p:acc_p + c.pack_size] = np.frombuffer(
                        stream, np.uint8, c.pack_size, c.data_off)
                    acc_p += c.pack_size
                    acc_u += c.unpack_size
                    pe[li, j] = acc_p
                    ue[li, j] = acc_u
                    f = G.FLAG_VALID | (0 if c.is_lzma else G.FLAG_COPY)
                    if ci == 0 and gi2 > 0:
                        f |= G.FLAG_RESET | G.FLAG_REBASE  # group boundary
                    elif ci > 0 and c.is_lzma and \
                            c.mode >= framing.MODE_STATE:
                        f |= G.FLAG_RESET
                    fl[li, j] = f
                    j += 1
            # padding entries repeat the final cumulative values, flags 0
            pe[li, j:] = acc_p
            ue[li, j:] = acc_u
            act[li] = 1
        return src, pe, ue, fl, act

    def _submit(self, src, pe, ue, fl, act, *, dic_cap: int,
                props) -> G.GroupBatch:
        lc, lp, pb = props
        return G.submit_groups(
            *G.prep_groups(src, pe, ue, fl, act, device=self.device),
            dic_cap=dic_cap, lc=lc, lp=lp, pb=pb)

    def _finalize(self, handle: G.GroupBatch, lanes, k: int, groups,
                  stream: bytes, offs, result, convert,
                  converted) -> list[int]:
        """Place a batch's ok lanes in ``result``, each group at its offset
        in ``offs``, once ``convert``'s groups are rewritten in their rows
        (added to ``converted`` where their lane is ok).  Returns the
        groups of failed lanes of several groups, to decode again one group
        per lane; a failed lane of one group raises.

        The reference's MtCoder poisons the whole ring on any thread error
        (``MtCoder.c:226-247``); here a bad group fails by itself,
        identified by its group index, and the other lanes are kept."""
        G.wait_batch(handle)
        placements = []
        for lane in lanes:
            at, placed = 0, []
            for gi in lane:
                n = offs[gi + 1] - offs[gi]
                placed.append((at, n, offs[gi]))
                at += n
            placements.append(placed)
        rewritten = self._convert_rows(handle, lanes, placements, convert)
        ok, _consumed = G.finalize_chunks(
            handle, dic_cap=k * self.shape.dic_cap, result=result,
            placements=placements)
        again: list[int] = []
        with TRACE.span("scheduler.outputs"):
            for lane, good in zip(lanes, ok.tolist()):
                if good:
                    converted.update(gi for gi in lane if gi in rewritten)
                    continue
                TRACE.add("scheduler.lane_retries")
                if len(lane) > 1:
                    again += lane
                    continue
                self._raise_failed(stream, groups[lane[0]], lane[0])
        return again

    @staticmethod
    def _convert_rows(handle: G.GroupBatch, lanes, placements,
                      convert) -> set[int]:
        """Runs ``convert``'s function of each group of the finished batch
        over its bytes in its lane's row, and moves the batch's event
        after them, so that the copy out waits for them.  Returns the
        groups rewritten."""
        done: set[int] = set()
        for li, (lane, placed) in enumerate(zip(lanes, placements)):
            for gi, (at, n, _) in zip(lane, placed):
                if gi in convert:
                    convert[gi](handle.out[li:li + 1, at:at + n])
                    done.add(gi)
        if done and handle.done is not None:
            with torch.cuda.device(handle.out.device):
                handle.done = torch.cuda.Event()
                handle.done.record()
        return done

    def _outputs(self, handle: G.GroupBatch, lane_groups, k: int):
        """Per lane of a batch, its groups' bytes in order, or None where
        the lane failed (``scheduler.lane_retries``).  The wait for the
        card is its own span, before the copies."""
        G.wait_batch(handle)
        out, ok, _consumed = G.finalize_chunks(
            handle, dic_cap=k * self.shape.dic_cap)
        with TRACE.span("scheduler.outputs"):
            out, ok = out.numpy(), ok.tolist()
            res = []
            for li, lg in enumerate(lane_groups):
                if not ok[li]:
                    TRACE.add("scheduler.lane_retries")
                    res.append(None)
                    continue
                ends = np.cumsum([0] + [_unpacked(g) for g in lg])
                res.append([out[li, a:b].tobytes()
                            for a, b in zip(ends[:-1], ends[1:])])
            del out     # the batch's host output, freed inside the span
        return res

    # -- the hybrid engine's per-batch pair ---------------------------------
    def submit_batch(self, stream: bytes, groups: list[list[framing.Chunk]],
                     props) -> G.GroupBatch:
        """Launch one batch of ``groups`` of one (lc, lp, pb), one group per
        lane (each within the shape, ``_eligible``), without waiting."""
        return self._submit(*self._assemble(stream, [[g] for g in groups], 1),
                            dic_cap=self.shape.dic_cap, props=props)

    def finalize_batch(self, handle: G.GroupBatch,
                       groups: list[list[framing.Chunk]]
                       ) -> list[bytes | None]:
        """Each group's bytes of a ``submit_batch`` batch, in order; None
        where its lane failed (``_raise_failed`` names the fault)."""
        return [None if parts is None else parts[0]
                for parts in self._outputs(handle, [[g] for g in groups], 1)]

    @staticmethod
    def _raise_failed(stream: bytes, group: list[framing.Chunk], gi: int):
        """The device failed group ``gi`` alone in its lane: the host
        decoder names the fault.  If the host decodes the group, the kernel
        disagrees with the reference, which is a bug, not bad data."""
        try:
            framing.decode_chunks(stream, group)
        except Exception as e:
            raise DataError(
                f"LZMA2 decode failed for dict-reset group {gi} (device "
                f"verdict and host retry both failed): {e}") from e
        raise RuntimeError(
            f"group decode failed dict-reset group {gi}, which the host "
            "reference decodes: the kernel disagrees with the reference")
