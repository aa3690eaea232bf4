"""Kernel K1 and its host wrapper: lane-parallel decode of LZMA2 groups.

The counterpart of the JAX package's ``ops/pallas_decode.py`` host wrapper
(``submit_groups`` / ``finalize_chunks`` / ``submit_chunks`` /
``decode_chunks``) with the same arguments and flag bits.  Each of S lanes
decodes one or more whole dict-reset groups: ``src[S, pack_cap]`` holds a
lane's chunk bodies back to back (LZMA chunks: 5 range-coder header bytes
plus payload; copy chunks: the raw bytes), ``pack_ends`` / ``unpack_ends`` /
``flags`` are ``[S, C]`` int32 chunk tables with cumulative ends, and the
lane's output is its row of ``out[S, dic_cap]``.  Flag bits:

* bit0 (1): valid chunk; padding entries have flags 0 and repeat the
  previous cumulative ends;
* bit1 (2): reset probabilities, state and reps (chunk 0 starts fresh
  without it);
* bit2 (4): uncompressed copy chunk, moved inside the kernel;
* bit3 (8): dictionary rebase, ``dbase = outpos``: a lane may carry several
  dict-reset groups back to back, each group's first chunk flagged
  bit1|bit3; positions, the literal context and distance checks count from
  ``dbase``.

There is no cap on C.  ``ok = no error and the lane ended at its last
cumulative ends``; an inactive lane reports ok.  A corrupt lane fails alone.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/group_decode.cu``) or raises; on a CPU tensor it runs the plain
version, ``group_decode_plain``, a lane-batched lockstep decoder on torch
tensors.  ``launches`` counts kernel launches.  Beside ``ok`` and
``consumed`` both report, per lane, the packets decoded (``iterations``)
and the range-coder bit calls (``bit_calls``, direct bits included): the
length of the lane's serial chain.  These four status rows and a copy of
``active`` share one ``[5, S]`` tensor, which ``finalize_chunks`` copies
to the host at once; from it each batch adds its active lanes to the
counter ``group_decode.lanes`` and its longest chain to
``group_decode.chain_bit_calls``.  With spans on (``utils/trace.py``) a
launch is bracketed by timing CUDA events, and K1's time goes to
``group_decode.kernel_ms`` once the batch has been waited on.

``finalize_chunks`` either returns the batch's rows as CPU tensors or,
given a ``result`` and each lane's ``placements``, writes each ok lane's
used bytes straight to their places in the result.  On the card those bytes
cross the link once, in pieces of ``PIECE`` bytes through two pinned
buffers on a copy stream that every call on that card reuses (the status
rows go the same way first), and the host places one piece while the next
is copied; ``group_decode.d2h_staged_bytes`` counts the output bytes staged
so.  On the CPU the rows are placed directly.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
import time

import numpy as np
import torch

from ..models.lzma import spec as S
from ..utils.errors import ParamError
from ..utils.trace import TRACE

FLAG_VALID = 1
FLAG_RESET = 2
FLAG_COPY = 4
FLAG_REBASE = 8

launches = 0   # K1 launches on the card; set to 0 to start a count

# The launcher refuses a pack_cap or dic_cap of this many bytes or more
# (``lzt_group_decode`` in csrc/group_decode.cu); the scheduler decodes
# larger groups on the host.
CAP_LIMIT = 1 << 31

PIECE = 16 << 20     # bytes per pinned piece of a staged copy out

# lzt_group_decode(src, pack_cap, pack_ends, unpack_ends, flags, n_chunks,
#                  active, out, dic_cap, ok, consumed, iterations, bit_calls,
#                  n_lanes, lc, lp, pb, stream) in csrc/group_decode.cu
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LAUNCH_ARGTYPES = [_P, _L, _P, _P, _P, _I, _P, _P, _L, _P, _P, _P, _P,
                    _I, _I, _I, _I, _P]


@dataclasses.dataclass
class GroupBatch:
    """A submitted batch: device tensors, filled once the stream reaches them."""

    out: torch.Tensor          # uint8 [S, dic_cap]
    ok: torch.Tensor           # int32 [S]
    consumed: torch.Tensor     # int32 [S]
    iterations: torch.Tensor   # int32 [S] packets per lane
    bit_calls: torch.Tensor    # int32 [S] range-coder bit calls per lane
    # on the card: recorded on the launch stream after the kernel
    done: torch.cuda.Event | None = None
    # the four rows above and ``active``, int32 [5, S]
    status: torch.Tensor | None = None
    # with spans on, recorded before the kernel (``done`` then times it);
    # None once its time is counted
    start: torch.cuda.Event | None = None


def check_tensors(specs, dev) -> None:
    """Raise unless each (name, tensor, dtype, shape or None) of ``specs`` is
    a contiguous tensor of that dtype and shape on ``dev``."""
    for name, t, dtype, shape in specs:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def check_props(lc: int, lp: int, pb: int) -> None:
    """The kernels' models are sized for LZMA2's lc + lp <= 4."""
    if not (0 <= lc <= 8 and 0 <= lp <= 4 and 0 <= pb <= 4) or lc + lp > 4:
        raise ParamError(f"unsupported lc/lp/pb {lc}/{lp}/{pb} "
                         "(LZMA2 needs lc + lp <= 4)")


def _check(src, pack_ends, unpack_ends, flags, active, dic_cap, lc, lp, pb):
    n = src.shape[0] if src.dim() == 2 else -1
    check_tensors((("src", src, torch.uint8, None),
                   ("pack_ends", pack_ends, torch.int32, None),
                   ("unpack_ends", unpack_ends, torch.int32, pack_ends.shape),
                   ("flags", flags, torch.int32, pack_ends.shape),
                   ("active", active, torch.int32, (n,))), src.device)
    if src.dim() != 2 or src.shape[1] < 1:
        raise ValueError(f"src must be [S, pack_cap>0], got {tuple(src.shape)}")
    if pack_ends.dim() != 2 or pack_ends.shape[0] != n or pack_ends.shape[1] < 1:
        raise ValueError(f"chunk tables must be [S, C>0], got "
                         f"{tuple(pack_ends.shape)}")
    if dic_cap < 1:
        raise ValueError(f"dic_cap must be positive, got {dic_cap}")
    check_props(lc, lp, pb)


def prep_groups(src, pack_ends, unpack_ends, flags, active, *, device):
    """Host arrays of one batch as the tensors ``submit_groups`` takes, on
    ``device``: src uint8 [S, pack_cap], the chunk tables int32 [S, C],
    active int32 [S]."""
    types = (torch.uint8, torch.int32, torch.int32, torch.int32, torch.int32)
    with TRACE.span("group_decode.h2d"):
        return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(device, t)
                     for a, t in zip((src, pack_ends, unpack_ends, flags,
                                      active), types))


def submit_groups(src: torch.Tensor, pack_ends: torch.Tensor,
                  unpack_ends: torch.Tensor, flags: torch.Tensor,
                  active: torch.Tensor, *, dic_cap: int, lc: int = 3,
                  lp: int = 0, pb: int = 2) -> GroupBatch:
    """Enqueue one decode of multi-chunk groups.

    On the card this launches K1 on ``torch.cuda.current_stream()``,
    records an event after it there (``batch_done``; with spans on, a
    timing pair around the launch) and returns without synchronising; on
    the CPU it decodes now with the plain version.  Tensors: src uint8 [S,
    pack_cap]; pack_ends, unpack_ends, flags int32 [S, C]; active int32
    [S]; all on one device, contiguous.
    """
    global launches
    _check(src, pack_ends, unpack_ends, flags, active, dic_cap, lc, lp, pb)
    with TRACE.span("group_decode.launch"):
        if src.device.type == "cpu":
            return _submit_plain(src, pack_ends, unpack_ends, flags, active,
                                 dic_cap, lc, lp, pb)
        from . import _build
        fn = _build.library("group_decode").lzt_group_decode
        fn.restype = ctypes.c_int
        fn.argtypes = _LAUNCH_ARGTYPES
        n = src.shape[0]
        start = None
        with torch.cuda.device(src.device):
            out = torch.zeros((n, dic_cap), dtype=torch.uint8,
                              device=src.device)
            status = torch.empty((5, n), dtype=torch.int32,
                                 device=src.device)
            status[4].copy_(active)
            stream = torch.cuda.current_stream(src.device).cuda_stream
            if TRACE.on:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            rc = fn(src.data_ptr(), src.shape[1], pack_ends.data_ptr(),
                    unpack_ends.data_ptr(), flags.data_ptr(),
                    pack_ends.shape[1], active.data_ptr(), out.data_ptr(),
                    dic_cap, *(row.data_ptr() for row in status[:4]), n, lc,
                    lp, pb, stream)
            if rc != 0:
                raise RuntimeError(
                    f"group_decode kernel launch failed: CUDA error {rc}")
            done = torch.cuda.Event(enable_timing=start is not None)
            done.record()
        launches += 1
        return GroupBatch(out, *status[:4], done=done, status=status,
                          start=start)


def _submit_plain(src, pack_ends, unpack_ends, flags, active, dic_cap, lc,
                  lp, pb) -> GroupBatch:
    """``submit_groups`` on the CPU: the plain version decodes now (its
    host time is K1's time with spans on)."""
    t0 = time.perf_counter_ns()
    out, *rows = group_decode_plain(src, pack_ends, unpack_ends, flags,
                                    active, dic_cap, lc, lp, pb)
    if TRACE.on:
        TRACE.add("group_decode.kernel_ms",
                  (time.perf_counter_ns() - t0) * 1e-6)
    status = torch.stack(rows + [active])
    return GroupBatch(out, *status[:4], status=status)


def submit_groups_sharded(src, pack_ends, unpack_ends, flags, active, *,
                          dic_cap: int, world: int, rank: int, lc: int = 3,
                          lp: int = 0, pb: int = 2,
                          device="cuda") -> GroupBatch:
    """``submit_groups`` of rank ``rank``'s lanes of a batch dealt over
    ``world`` ranks (the JAX package's ``submit_groups_sharded``).

    Every rank holds the whole batch as host arrays (src uint8 [S,
    pack_cap], the chunk tables int32 [S, C], active int32 [S]; the stream
    bytes are the broadcast) and decodes the contiguous block
    ``parallel/mesh.lane_shard(S, world, rank)`` on ``device``: K1 on a
    card, the plain version on the CPU.  Lanes are independent, so nothing
    crosses ranks during the decode.  Returns a ``GroupBatch`` of those
    lanes, in order, for ``finalize_chunks``.  Raises ValueError unless the
    S lanes split evenly over ``world``."""
    from ..parallel.mesh import lane_shard
    shard = lane_shard(len(src), world, rank)
    return submit_groups(
        *prep_groups(*(a[shard] for a in (src, pack_ends, unpack_ends, flags,
                                          active)), device=device),
        dic_cap=dic_cap, lc=lc, lp=lp, pb=pb)


def batch_done(handle: GroupBatch) -> bool:
    """Whether a submitted batch has finished, without waiting: the launch
    stream has passed the batch's event (always true on the CPU, where
    ``submit_groups`` decodes at once)."""
    return handle.done is None or handle.done.query()


def wait_batch(handle: GroupBatch) -> None:
    """Blocks until the card has finished a submitted batch (span
    ``group_decode.wait``; nothing to wait for on the CPU)."""
    with TRACE.span("group_decode.wait"):
        if handle.done is not None:
            handle.done.synchronize()
    _count_kernel_ms(handle)


def _count_kernel_ms(handle: GroupBatch) -> None:
    """Adds a finished, timed launch's CUDA-event time to
    ``group_decode.kernel_ms``, once."""
    if handle.start is not None:
        TRACE.add("group_decode.kernel_ms",
                  handle.start.elapsed_time(handle.done))
        handle.start = None


def launch_geometry(n_lanes: int, dic_cap: int, lc: int = 3, lp: int = 0,
                    device=None) -> dict:
    """The geometry ``submit_groups`` launches K1 with on the current card:
    the dictionary window (bytes of shared memory ring per lane), the
    dynamic shared memory per block and the blocks resident per SM."""
    from . import _build
    fn = _build.library("group_decode").lzt_group_decode_geometry
    fn.restype = ctypes.c_int
    fn.argtypes = [_I, _L, _I, _I, _P]
    res = (ctypes.c_int32 * 3)()
    with torch.cuda.device(device):
        rc = fn(n_lanes, dic_cap, lc, lp, ctypes.addressof(res))
    if rc != 0:
        raise RuntimeError(f"group_decode geometry failed: CUDA error {rc}")
    return {"window": res[0], "smem_per_block": res[1],
            "blocks_per_sm": res[2]}


def finalize_chunks(handle: GroupBatch, *, dic_cap: int, result=None,
                    placements=None):
    """Materialize a submitted batch on the host.

    Without ``result``: (out, ok, consumed), out uint8 [S, dic_cap], ok
    bool [S], consumed int32 [S], CPU tensors; the status rows come over in
    one copy with the output.

    With ``result``, a writable uint8 numpy array, and ``placements``, a
    list per lane of (row offset, length, result offset) within the first
    ``dic_cap`` bytes of its row: writes those bytes of every ok lane into
    ``result`` and returns (ok, consumed).  No other byte of the rows, and
    nothing of a failed lane, is copied.

    The copies are span ``group_decode.d2h``; the batch's lanes and longest
    bit-call chain go to the trace's counters."""
    with TRACE.span("group_decode.d2h"):
        if result is None:
            out = handle.out[:, :dic_cap].cpu()
            status = handle.status.cpu()
        else:
            status = torch.from_numpy(_place(handle, dic_cap, result,
                                             placements))
    _count_kernel_ms(handle)
    rows = status.numpy()
    TRACE.add("group_decode.lanes", int(np.count_nonzero(rows[4])))
    TRACE.add("group_decode.chain_bit_calls", int(rows[3].max(initial=0)))
    if result is None:
        return out, status[0] != 0, status[1]
    return status[0] != 0, status[1]


def _place(handle: GroupBatch, dic_cap: int, result: np.ndarray,
           placements) -> np.ndarray:
    """``finalize_chunks``' placement: the status rows, int32 [5, S] on the
    host, once each ok lane's placements are written into ``result``."""
    out = handle.out
    n_lanes, width = out.shape
    if not 0 < dic_cap <= width or len(placements) > n_lanes:
        raise ValueError(f"placements of {len(placements)} lanes within "
                         f"{dic_cap} bytes for rows [{n_lanes}, {width}]")
    if out.device.type == "cuda":
        rows = np.empty((5, n_lanes), np.int32)
        staging = _staging(out.device)
        with staging.lock:
            staging.copy(handle.status.view(torch.uint8).view(-1),
                         [(0, rows.nbytes, 0)], rows.view(np.uint8).ravel(),
                         after=handle.done)
            segments = _segments(rows[0], placements, width, dic_cap)
            TRACE.add("group_decode.d2h_staged_bytes",
                      staging.copy(out.view(-1), segments, result,
                                   after=handle.done))
        return rows
    rows = handle.status.numpy()
    flat = out.view(-1).numpy()
    for src, n, dst in _segments(rows[0], placements, width, dic_cap):
        result[dst:dst + n] = flat[src:src + n]
    return rows


def _segments(ok, placements, width: int, dic_cap: int):
    """(offset in the flat rows, length, result offset) of each placement
    of an ok lane, in row order."""
    segments = []
    for li, lane in enumerate(placements):
        if not ok[li]:
            continue
        for at, n, dst in lane:
            if at < 0 or n < 0 or at + n > dic_cap or dst < 0:
                raise ValueError(f"placement ({at}, {n}, {dst}) of lane {li} "
                                 f"outside its {dic_cap} bytes")
            if n:
                segments.append((li * width + at, n, dst))
    return segments


def _piece_plan(segments, piece: int):
    """Byte segments (source offset, length, destination offset) laid back
    to back in pieces of ``piece`` bytes: a list per piece of (source
    offset, piece offset, length, destination offset), a segment that
    crosses a piece's end cut in two."""
    pieces, parts, fill = [], [], 0
    for src, n, dst in segments:
        while n:
            m = min(n, piece - fill)
            parts.append((src, fill, m, dst))
            src, dst, n, fill = src + m, dst + m, n - m, fill + m
            if fill == piece:
                pieces.append(parts)
                parts, fill = [], 0
    if parts:
        pieces.append(parts)
    return pieces


def _runs(parts, at: int):
    """[start, piece offset, length] of the runs of a piece's ``parts``
    that are contiguous at field ``at`` (0 the source, 3 the destination;
    in the piece they always are)."""
    runs: list[list[int]] = []
    for part in parts:
        if runs and runs[-1][0] + runs[-1][2] == part[at]:
            runs[-1][2] += part[2]
        else:
            runs.append([part[at], part[1], part[2]])
    return runs


class _Staging:
    """Two pinned host pieces of ``PIECE`` bytes and a copy stream on one
    card, reused by every staged copy there, one at a time (``lock``)."""

    def __init__(self, device: torch.device):
        self.lock = threading.Lock()
        self.stream = torch.cuda.Stream(device)
        self.copied = [torch.cuda.Event(), torch.cuda.Event()]
        self.host: list[torch.Tensor] = []

    def _pieces(self) -> list[torch.Tensor]:
        if not self.host or self.host[0].numel() != PIECE:
            self.host = [torch.empty(PIECE, dtype=torch.uint8,
                                     pin_memory=True) for _ in range(2)]
        return self.host

    def copy(self, src: torch.Tensor, segments, dst: np.ndarray, *,
             after: torch.cuda.Event | None) -> int:
        """Copies ``segments`` (source offset, length, destination offset)
        of the flat uint8 card tensor ``src`` into the host array ``dst``,
        once the card has passed ``after``: piece k + 1 crosses the link on
        the copy stream while the host places piece k.  Returns the bytes
        copied."""
        host = self._pieces()
        views = [h.numpy() for h in host]
        pieces = _piece_plan(segments, PIECE)
        stream = self.stream

        def send(k: int) -> None:
            b = k & 1
            with torch.cuda.stream(stream):
                for at, off, n in _runs(pieces[k], 0):
                    host[b][off:off + n].copy_(src[at:at + n],
                                               non_blocking=True)
            self.copied[b].record(stream)

        try:
            if after is not None:
                stream.wait_event(after)
            for k in range(min(2, len(pieces))):
                send(k)
            for k, parts in enumerate(pieces):
                self.copied[k & 1].synchronize()
                view = views[k & 1]
                for at, off, n in _runs(parts, 3):
                    dst[at:at + n] = view[off:off + n]
                if k + 2 < len(pieces):
                    send(k + 2)
        finally:
            stream.synchronize()    # nothing left in flight on a raise
        return sum(n for _, n, _ in segments)


_STAGING: dict[int, _Staging] = {}     # card index -> its pieces
_STAGING_LOCK = threading.Lock()


def _staging(device: torch.device) -> _Staging:
    with _STAGING_LOCK:
        if device.index not in _STAGING:
            _STAGING[device.index] = _Staging(device)
        return _STAGING[device.index]


def submit_chunks(src: torch.Tensor, pack_len: torch.Tensor,
                  unpack_len: torch.Tensor, active: torch.Tensor, *,
                  dic_cap: int, lc: int = 3, lp: int = 0,
                  pb: int = 2) -> GroupBatch:
    """Single-chunk-per-group convenience wrapper over submit_groups."""
    active = active.to(torch.int32)
    return submit_groups(
        src, pack_len.to(torch.int32)[:, None].contiguous(),
        unpack_len.to(torch.int32)[:, None].contiguous(),
        (active != 0).to(torch.int32)[:, None].contiguous(),
        active.contiguous(), dic_cap=dic_cap, lc=lc, lp=lp, pb=pb)


def decode_chunks(src: torch.Tensor, pack_len: torch.Tensor,
                  unpack_len: torch.Tensor, active: torch.Tensor, *,
                  dic_cap: int, lc: int = 3, lp: int = 0, pb: int = 2):
    """Decode one single-chunk group per lane (submit + finalize)."""
    return finalize_chunks(
        submit_chunks(src, pack_len, unpack_len, active, dic_cap=dic_cap,
                      lc=lc, lp=lp, pb=pb), dic_cap=dic_cap)


def from_jax_batch(meta, words):
    """The JAX package's ``_prep_groups`` batch as this module's tensors.

    meta int32[6, S, 128] = pack total, unpack total, active, cumulative pack
    ends, cumulative unpack ends, flags; words int32[in_pages, S, 128] = the
    sources as little-endian word pages.  Returns CPU tensors
    ``(src, pack_ends, unpack_ends, flags, active)``; the chunk count is
    read from the flags (the last column any lane marks valid)."""
    meta = np.asarray(meta, np.int32)
    words = np.asarray(words, np.int32)
    n = meta.shape[1]
    used = np.nonzero((meta[5] != 0).any(axis=0))[0]
    c = int(used[-1]) + 1 if used.size else 1
    pe, ue, fl = (np.ascontiguousarray(meta[k, :, :c]) for k in (3, 4, 5))
    if not ((pe[:, -1] == meta[0, :, 0]).all()
            and (ue[:, -1] == meta[1, :, 0]).all()):
        raise ValueError("meta totals disagree with the chunk tables")
    src = (np.ascontiguousarray(words.transpose(1, 0, 2)).astype("<i4")
           .view(np.uint8).reshape(n, -1))
    return (torch.from_numpy(src.copy()), torch.from_numpy(pe),
            torch.from_numpy(ue), torch.from_numpy(fl),
            torch.from_numpy(np.ascontiguousarray(meta[2, :, 0])))


# ---------------------------------------------------------------------------
# plain version: lane-batched lockstep decoder on torch tensors
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_TOP = S.RC_TOP
_MAX_MATCH = S.MATCH_MAX_LEN


class _Lockstep:
    """Every live lane decodes one packet per step; masks keep lanes that
    take another branch, or have stopped, unchanged.  Per lane it follows
    ``csrc/lzma_lane.cuh`` step for step, so out, ok and consumed agree
    with the kernel on every input, failed lanes included."""

    def __init__(self, src, pe, ue, fl, active, dic_cap, lc, lp, pb):
        n, self.n_chunks = pe.shape
        self.src = src
        self.pack_cap = src.shape[1]
        self.pe, self.ue, self.fl = pe.long(), ue.long(), fl.long()
        self.dic_cap = dic_cap
        self.lc, self.lp_mask, self.pb_mask = lc, (1 << lp) - 1, (1 << pb) - 1
        self.n_probs = S.num_probs(lc, lp)
        self.out = torch.zeros((n, dic_cap), dtype=torch.uint8)
        self.probs = torch.full((n, self.n_probs), S.PROB_INIT,
                                dtype=torch.int32)
        self.rows = torch.arange(n)
        z = torch.zeros(n, dtype=torch.int64)
        self.rng, self.code, self.inpos, self.in_end = z, z, z, z
        self.pos, self.dbase, self.uend, self.chunk = z, z, z, z
        self.state, self.r0, self.r1, self.r2, self.r3 = z, z, z, z, z
        self.active = active != 0
        self.live = self.active.clone()
        self.err = torch.zeros(n, dtype=torch.bool)
        self.in_chunk = torch.zeros(n, dtype=torch.bool)
        self.iters, self.bits = z, z      # packets, bit calls per lane

    # -- memory ----------------------------------------------------------
    def _src_at(self, p):
        idx = p.clamp(0, self.pack_cap - 1)[:, None]
        return self.src.gather(1, idx)[:, 0].long()

    def _out_at(self, p):
        idx = p.clamp(0, self.dic_cap - 1)[:, None]
        return self.out.gather(1, idx)[:, 0].long()

    def _put(self, m, p, v):
        flat = (self.rows * self.dic_cap + p)[m]
        self.out.view(-1)[flat] = v[m].to(torch.uint8)

    def _fail(self, bad):
        self.err = self.err | bad

    # -- range coder -------------------------------------------------------
    def _normalize(self, m):
        need = m & (self.rng < _TOP)
        if not bool(need.any()):
            return
        eof = need & (self.inpos >= self.in_end)
        self._fail(eof)
        need = need & ~eof
        byte = self._src_at(self.inpos)
        self.rng = torch.where(need, (self.rng << 8) & _M32, self.rng)
        self.code = torch.where(need, ((self.code << 8) | byte) & _M32,
                                self.code)
        self.inpos = self.inpos + need.long()

    def _bit(self, m, idx):
        m = m & ~self.err
        if not bool(m.any()):
            return torch.zeros_like(idx)
        self._normalize(m)
        m = m & ~self.err
        self.bits = self.bits + m.long()
        idx = idx.clamp(0, self.n_probs - 1)[:, None]
        p = self.probs.gather(1, idx)[:, 0].long()
        bound = (self.rng >> S.RC_BIT_MODEL_TOTAL_BITS) * p
        b = self.code >= bound
        self.rng = torch.where(m, torch.where(b, self.rng - bound, bound),
                               self.rng)
        self.code = torch.where(m & b, self.code - bound, self.code)
        newp = torch.where(
            b, p - (p >> S.RC_MOVE_BITS),
            p + ((S.RC_BIT_MODEL_TOTAL - p) >> S.RC_MOVE_BITS))
        self.probs.scatter_(1, idx, torch.where(m, newp, p).int()[:, None])
        return b.long()

    def _direct_bit(self, m):
        m = m & ~self.err
        self._normalize(m)
        m = m & ~self.err
        self.bits = self.bits + m.long()
        rng = self.rng >> 1
        code = (self.code - rng) & _M32
        t = code >> 31
        code = (code + rng * t) & _M32
        self.rng = torch.where(m, rng, self.rng)
        self.code = torch.where(m, code, self.code)
        return 1 - t

    def _tree(self, m, base, nbits):
        sym = torch.ones_like(base)
        for _ in range(nbits):
            sym = (sym << 1) | self._bit(m, base + sym)
        return sym - (1 << nbits)

    def _tree_reverse(self, m, base, nbits, max_bits):
        """Reverse tree of per-lane ``nbits`` (≤ max_bits) bits."""
        node = torch.ones_like(base)
        sym = torch.zeros_like(base)
        for i in range(max_bits):
            mi = m & (i < nbits)
            b = self._bit(mi, base + node)
            node = torch.where(mi, (node << 1) | b, node)
            sym = torch.where(mi, sym | (b << i), sym)
        return sym

    def _len(self, m, base, ps):
        c1 = self._bit(m, base + S.LEN_CHOICE)
        m = m & ~self.err
        c2 = self._bit(m & (c1 == 1), base + S.LEN_CHOICE2)
        m = m & ~self.err
        low = m & (c1 == 0)
        mid = m & (c1 == 1) & (c2 == 0)
        high = m & (c1 == 1) & (c2 == 1)
        off = torch.where(low, base + S.LEN_LOW + (ps << S.LEN_LOW_BITS),
                          torch.where(mid, base + S.LEN_MID
                                      + (ps << S.LEN_MID_BITS),
                                      base + S.LEN_HIGH))
        node = torch.ones_like(base)
        for i in range(S.LEN_HIGH_BITS):
            mi = m if i < S.LEN_LOW_BITS else high
            if i >= S.LEN_LOW_BITS and not bool(mi.any()):
                break
            b = self._bit(mi, off + node)
            node = torch.where(mi, (node << 1) | b, node)
        return torch.where(
            high, S.MATCH_MIN_LEN + 16 + node - 256,
            torch.where(mid, S.MATCH_MIN_LEN + 8 + node - 8,
                        S.MATCH_MIN_LEN + node - 8))

    # -- packets -----------------------------------------------------------
    def _packet(self, m):
        ctx = self.pos - self.dbase
        ps = ctx & self.pb_mask
        b = self._bit(m, S.IS_MATCH + (self.state << S.NUM_POS_BITS_MAX) + ps)
        m = m & ~self.err
        lit, mat = m & (b == 0), m & (b == 1)
        if bool(lit.any()):
            self._literal(lit, ctx)
        if bool(mat.any()):
            self._match(mat, ctx, ps)

    def _literal(self, lit, ctx):
        pos, st, lc = self.pos, self.state, self.lc
        prev = torch.where(pos > self.dbase, self._out_at(pos - 1), 0)
        base = S.LITERAL + 0x300 * (((ctx & self.lp_mask) << lc)
                                    + (prev >> (8 - lc)))
        matched = lit & (st >= 7)
        bad = matched & (self.r0 >= ctx)
        self._fail(bad)
        lit, matched = lit & ~bad, matched & ~bad
        mb = torch.where(matched, self._out_at(pos - self.r0 - 1), 0)
        offs = torch.where(matched, 0x100, 0)
        sym = torch.ones_like(pos)
        for _ in range(8):
            mb = mb << 1
            bc = mb & offs
            b = self._bit(lit, base + offs + bc + sym)
            sym = (sym << 1) | b
            offs = torch.where(b == 1, offs & bc, offs & ~bc)
        done = lit & ~self.err
        self._put(done, pos, sym & 0xFF)
        self.pos = pos + done.long()
        after = torch.where(st < 4, 0, torch.where(st < 10, st - 3, st - 6))
        self.state = torch.where(done, after, st)

    def _match(self, mat, ctx, ps):
        st, pos = self.state, self.pos
        r = self._bit(mat, S.IS_REP + st)
        mat = mat & ~self.err
        rep, simple = mat & (r == 1), mat & (r == 0)
        self._fail(rep & (pos == self.dbase))
        rep = rep & ~self.err
        g0 = self._bit(rep, S.IS_REP_G0 + st)
        rep = rep & ~self.err
        r0l = rep & (g0 == 0)
        lng = self._bit(r0l, S.IS_REP0_LONG + (st << S.NUM_POS_BITS_MAX) + ps)
        r0l = r0l & ~self.err
        short = r0l & (lng == 0)
        self._fail(short & (self.r0 >= ctx))
        short = short & ~self.err
        if bool(short.any()):
            self._put(short, pos, self._out_at(pos - self.r0 - 1))
        # rep1..3: rotate the chosen distance to rep0
        g1m = rep & (g0 == 1)
        g1 = self._bit(g1m, S.IS_REP_G1 + st)
        g2m = g1m & ~self.err & (g1 == 1)
        g2 = self._bit(g2m, S.IS_REP_G2 + st)
        g1m = g1m & ~self.err
        dist = torch.where(g1 == 0, self.r1,
                           torch.where(g2 == 0, self.r2, self.r3))
        r3 = torch.where(g2m & (g2 == 1), self.r2, self.r3)
        r2 = torch.where(g2m, self.r1, self.r2)
        r1 = torch.where(g1m, self.r0, self.r1)
        r0 = torch.where(g1m, dist, self.r0)
        # simple match: shift the reps
        r3 = torch.where(simple, r2, r3)
        r2 = torch.where(simple, r1, r2)
        r1 = torch.where(simple, r0, r1)
        self.r1, self.r2, self.r3 = r1, r2, r3
        longrep = (r0l & (lng == 1)) | g1m
        ln = longrep | simple
        length = self._len(ln, torch.where(simple, S.LEN_CODER,
                                           S.REP_LEN_CODER), ps)
        simple = simple & ~self.err
        if bool(simple.any()):
            lps = (length - S.MATCH_MIN_LEN).clamp(max=S.NUM_LEN_TO_POS_STATES - 1)
            slot = self._tree(simple, S.POS_SLOT + (lps << S.NUM_POS_SLOT_BITS),
                              S.NUM_POS_SLOT_BITS)
            nd = ((slot >> 1) - 1).clamp(min=0)
            hi = simple & (slot >= 4)
            d = torch.where(hi, (2 | (slot & 1)) << nd, slot)
            spec = hi & (slot < S.END_POS_MODEL_INDEX)
            if bool(spec.any()):
                d = d + torch.where(spec, self._tree_reverse(
                    spec, S.SPEC_POS + d - slot - 1, nd, 5), 0)
            far = hi & (slot >= S.END_POS_MODEL_INDEX)
            if bool(far.any()):
                nbits = nd - S.NUM_ALIGN_BITS
                res = torch.zeros_like(d)
                for i in range(26):
                    mi = far & (i < nbits)
                    if not bool(mi.any()):
                        break
                    b = self._direct_bit(mi)
                    res = torch.where(mi, (res << 1) + b, res)
                al = self._tree_reverse(far, torch.full_like(d, S.ALIGN),
                                        torch.full_like(d, S.NUM_ALIGN_BITS),
                                        S.NUM_ALIGN_BITS)
                d = torch.where(far, d + (res << S.NUM_ALIGN_BITS) + al, d)
            simple = simple & ~self.err
            self._fail(simple & (d == _M32))   # end marker in a sized chunk
            simple = simple & ~self.err
            r0 = torch.where(simple, d, r0)
        self.r0 = r0
        ln = ln & ~self.err
        self._fail(ln & ((r0 + 1 > ctx) | (pos + length > self.uend)))
        ln = ln & ~self.err
        if bool(ln.any()):
            j = torch.arange(_MAX_MATCH)[None, :]
            dist = (r0 + 1)[:, None]
            valid = ln[:, None] & (j < length[:, None])
            src = (pos[:, None] - dist + j % dist).clamp(0, self.dic_cap - 1)
            vals = self.out.gather(1, src)
            flat = (self.rows * self.dic_cap + pos)[:, None] + j
            self.out.view(-1)[flat[valid]] = vals[valid]
        self.pos = pos + short.long() + torch.where(ln, length, 0)
        young = st < 7
        after = torch.where(short, torch.where(young, 9, 11), st)
        after = torch.where(ln & longrep, torch.where(young, 8, 11), after)
        after = torch.where(ln & ~longrep, torch.where(young, 7, 10), after)
        self.state = after

    # -- chunk transitions -------------------------------------------------
    def _end_chunks(self):
        m = self.live & self.in_chunk & (self.pos >= self.uend)
        if not bool(m.any()):
            return
        need = m & (self.rng < _TOP) & (self.inpos < self.in_end)
        byte = self._src_at(self.inpos)
        self.rng = torch.where(need, (self.rng << 8) & _M32, self.rng)
        self.code = torch.where(need, ((self.code << 8) | byte) & _M32,
                                self.code)
        self.inpos = self.inpos + need.long()
        self._fail(m & (self.inpos != self.in_end))
        self.in_chunk = self.in_chunk & ~m
        self.chunk = self.chunk + m.long()

    def _start_chunks(self):
        last = self.n_chunks - 1
        while True:
            self.live = self.live & ~self.err
            m = self.live & ~self.in_chunk
            finished = m & (self.chunk > last)
            self.live = self.live & ~finished
            m = m & ~finished
            if not bool(m.any()):
                return
            j = self.chunk.clamp(max=last)[:, None]
            f = self.fl.gather(1, j)[:, 0]
            pend = self.pe.gather(1, j)[:, 0]
            uend = self.ue.gather(1, j)[:, 0]
            skip = m & ((f & FLAG_VALID) == 0)
            self.chunk = self.chunk + skip.long()
            v = m & ~skip
            self._fail(v & ((pend < self.inpos) | (pend > self.pack_cap)
                            | (uend < self.pos) | (uend > self.dic_cap)))
            v = v & ~self.err
            self.dbase = torch.where(v & ((f & FLAG_REBASE) != 0), self.pos,
                                     self.dbase)
            reset = v & ((f & FLAG_RESET) != 0)
            if bool(reset.any()):
                self.probs[reset] = S.PROB_INIT
                for name in ("state", "r0", "r1", "r2", "r3"):
                    setattr(self, name,
                            torch.where(reset, 0, getattr(self, name)))
            copy = v & ((f & FLAG_COPY) != 0)
            self._fail(copy & (pend - self.inpos != uend - self.pos))
            copy = copy & ~self.err
            if bool(copy.any()):
                size = torch.where(copy, uend - self.pos, 0)
                j = torch.arange(int(size.max()))[None, :]
                valid = j < size[:, None]
                vals = self.src.gather(
                    1, (self.inpos[:, None] + j).clamp(0, self.pack_cap - 1))
                flat = (self.rows * self.dic_cap + self.pos)[:, None] + j
                self.out.view(-1)[flat[valid]] = vals[valid]
                self.inpos = torch.where(copy, pend, self.inpos)
                self.pos = torch.where(copy, uend, self.pos)
                self.chunk = self.chunk + copy.long()
            lz = v & ((f & FLAG_COPY) == 0)
            self._fail(lz & ((pend - self.inpos < 5)
                             | (self._src_at(self.inpos) != 0)))
            lz = lz & ~self.err
            if bool(lz.any()):
                code = torch.zeros_like(self.code)
                for k in range(1, 5):
                    code = (code << 8) | self._src_at(self.inpos + k)
                self.code = torch.where(lz, code, self.code)
                self.rng = torch.where(lz, _M32, self.rng)
                self.inpos = self.inpos + 5 * lz.long()
                self.in_end = torch.where(lz, pend, self.in_end)
                self.uend = torch.where(lz, uend, self.uend)
                self.in_chunk = self.in_chunk | lz

    def run(self):
        while True:
            self._end_chunks()
            self._start_chunks()
            m = self.live & self.in_chunk & (self.pos < self.uend)
            if bool(m.any()):
                self.iters = self.iters + m.long()
                self._packet(m)
            elif not bool(self.live.any()):
                break
            self.live = self.live & ~self.err
        ok = ~self.active | (~self.err & (self.pos == self.ue[:, -1])
                             & (self.inpos == self.pe[:, -1]))
        return (self.out, ok.to(torch.int32),
                torch.where(self.active, self.inpos, 0).to(torch.int32),
                self.iters.to(torch.int32), self.bits.to(torch.int32))


def group_decode_plain(src, pack_ends, unpack_ends, flags, active,
                       dic_cap: int, lc: int = 3, lp: int = 0, pb: int = 2):
    """The plain PyTorch version of K1 on CPU tensors.

    Same arguments as ``submit_groups``; returns (out uint8 [S, dic_cap],
    ok int32 [S], consumed int32 [S], packets int32 [S], bit calls
    int32 [S]), the fields of ``GroupBatch`` in order.  The kernel's packets
    and bit calls agree on every lane that ends ok; on a failed lane they
    may differ, since the kernel decodes the failing packet to its end
    before it checks."""
    return _Lockstep(src, pack_ends, unpack_ends, flags, active, dic_cap,
                     lc, lp, pb).run()
