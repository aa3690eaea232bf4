"""Kernel K2 and its host wrapper: lane-parallel LZMA range encode.

The counterpart of the JAX package's ``ops/pallas_encode.py`` host wrapper
(``pack_ops_batch`` / ``submit_encode_groups`` / ``finalize_encode``).  Each
of S lanes replays one dict-reset group's op records (from the host's fast
parse, ``native.lzma2_group_ops``) through the adaptive model and the range
coder, and writes the group's chunk bodies, byte-identical to the native
encoder's.  Per lane (the contract of ``csrc/lzma_enc_lane.cuh``):

* ``ops`` int32 [S, op_cap]: the op records' uint32 words, 2 per op;
* ``op_ends`` int32 [S, C]: cumulative op-word end of each chunk; padding
  entries repeat the last end (a chunk with no ops writes no body);
* ``active`` int32 [S]: an inactive lane reports ok with 0 bytes;
* out: ``bodies`` uint8 [S, out_cap], ``tab`` int32 [S, C] (cumulative body
  end of each finished chunk), ``status`` int32 [4, S] = ok, bytes written,
  err (1 bad chunk table, 2 bad op record, 3 body past out_cap), bit calls
  (direct bits included; calls that begin after an error do not count).
  A lane that fails stops alone.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/range_encode.cu``) or raises; on a CPU tensor it runs the plain
version, ``range_encode_plain``, a lane-batched lockstep encoder on torch
tensors.  The kernel is three CUDA launches in order -- the model walk (a
warp per lane), the chunk coders (a warp per chunk) and the gather (a block
per lane) -- over a scratch area of ``scratch_lane_bytes`` per lane that
the wrapper allocates; ``launches`` counts one per ``submit_encode_groups``
that reaches the card, whatever the number of CUDA launches.  The launches
are bracketed by CUDA events; ``finalize_encode`` adds the whole to the
``range_encode.kernel_ms`` counter and each launch's share to
``range_encode.walk_ms`` / ``.code_ms`` / ``.gather_ms``, keeps the most
bit calls of a lane (``range_encode.bit_calls_max``), and times its wait
for the kernel and its copy to the host (``utils/trace.TRACE``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..models.lzma import spec as S
from ..utils.trace import TRACE
from .group_decode import check_props, check_tensors

launches = 0   # K2 launches on the card; set to 0 to start a count

ERR_TABLE, ERR_OP, ERR_OVERFLOW = 1, 2, 3

# The launcher refuses op rows of this many words or more, and body rows of
# this many bytes or more (``lzt_range_encode`` in csrc/range_encode.cu);
# the device-coded encoder sends such groups to the host encoder.
OP_CAP_LIMIT = 1 << 27
OUT_CAP_LIMIT = 1 << 31

# lzt_range_encode(ops, op_cap, op_ends, n_chunks, active, out, out_cap, tab,
#                  ok, bytes, err, bits, n_lanes, lc, lp, pb, scratch,
#                  scratch_stride, marks, stream) in csrc/range_encode.cu
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LAUNCH_ARGTYPES = [_P, _L, _P, _I, _P, _P, _L, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _P, _L, _P, _P]
STEPS = ("walk", "code", "gather")   # the kernel's launches, in order


def _round16(v: int) -> int:
    return (v + 15) & ~15


def scratch_lane_bytes(op_cap: int, n_chunks: int) -> int:
    """Scratch bytes one lane of the kernel holds (``scratch_layout`` in
    ``csrc/lzma_enc_lane.cuh``): the walk's result, each chunk's stream span,
    body length and bit calls, the coder's stream (26 bytes per op word and
    16 per chunk) and each chunk's body slot (20 bytes per op plus 32 per
    chunk); the bounds are proved there."""
    return (16 + 16 * n_chunks + _round16(26 * op_cap) + 16 * n_chunks
            + _round16(10 * op_cap) + 32 * n_chunks)


@dataclasses.dataclass
class EncodeBatch:
    """A submitted batch: device tensors, filled once the stream reaches them."""

    bodies: torch.Tensor       # uint8 [S, out_cap]
    tab: torch.Tensor          # int32 [S, C]
    status: torch.Tensor       # int32 [4, S]: ok, bytes, err, bit calls
    # on the card: events before, between and after the launches, and the
    # scratch area, held until the batch is finalized
    marks: list | None = None
    scratch: torch.Tensor | None = None


def out_cap_for(max_unpack: int) -> int:
    """Body bytes a lane may write: its group's unpacked size plus an eighth
    plus 4096 (``pallas_encode.py:818``).  Groups whose bodies do not
    compress are the host encoder's copy-chunk case, never a lane's."""
    return max_unpack + (max_unpack >> 3) + 4096


def op_row_words(n_words: int) -> int:
    """Words of a batch's op rows for a longest lane of ``n_words``: a
    multiple of 4, so that every row is 16-byte aligned for the kernel's
    16-byte staging copies."""
    return max(4, -(-n_words // 4) * 4)


def pack_ops_batch(lane_ops, lane_tabs):
    """Per-lane op streams and chunk tables (``native.lzma2_group_ops``) as
    one batch of CPU tensors.

    Returns ``(ops, op_ends, active, out_cap, lane_nchunks)``: ops int32
    [S, op_cap], op_ends int32 [S, C], active int32 [S], one lane per op
    stream given; a lane with no ops is inactive."""
    n = len(lane_ops)
    op_cap = op_row_words(max((len(o) for o in lane_ops), default=0))
    n_chunks = max(1, max((len(t) for t in lane_tabs), default=1))
    ops = np.zeros((n, op_cap), np.uint32)
    ends = np.zeros((n, n_chunks), np.int32)
    active = np.zeros(n, np.int32)
    max_unpack = 0
    for s, (o, tab) in enumerate(zip(lane_ops, lane_tabs)):
        if len(o) == 0:
            continue
        ops[s, :len(o)] = o
        ends[s, :len(tab)] = tab[:, 0]
        ends[s, len(tab):] = tab[-1, 0]
        active[s] = 1
        max_unpack = max(max_unpack, int(tab[-1, 1]))
    return (torch.from_numpy(ops.view(np.int32)), torch.from_numpy(ends),
            torch.from_numpy(active), out_cap_for(max_unpack),
            [len(t) for t in lane_tabs])


def _check(ops, op_ends, active, out_cap, lc, lp, pb):
    n = ops.shape[0] if ops.dim() == 2 else -1
    check_tensors((("ops", ops, torch.int32, None),
                   ("op_ends", op_ends, torch.int32, None),
                   ("active", active, torch.int32, (n,))), ops.device)
    if ops.dim() != 2 or ops.shape[1] < 2:
        raise ValueError(f"ops must be [S, op_cap>=2], got {tuple(ops.shape)}")
    if op_ends.dim() != 2 or op_ends.shape[0] != n or op_ends.shape[1] < 1:
        raise ValueError(f"op_ends must be [S, C>0], got "
                         f"{tuple(op_ends.shape)}")
    if not 1 <= out_cap < OUT_CAP_LIMIT:
        raise ValueError(f"out_cap must be in [1, 2^31), got {out_cap}")
    check_props(lc, lp, pb)


def submit_encode_groups(ops: torch.Tensor, op_ends: torch.Tensor,
                         active: torch.Tensor, *, out_cap: int, lc: int = 3,
                         lp: int = 0, pb: int = 2) -> EncodeBatch:
    """Enqueue one range encode of a batch of groups.

    On the card this launches K2 on ``torch.cuda.current_stream()`` and
    returns without synchronising; on the CPU it encodes now with the plain
    version.  Tensors: ops int32 [S, op_cap]; op_ends int32 [S, C]; active
    int32 [S]; all on one device, contiguous.
    """
    global launches
    _check(ops, op_ends, active, out_cap, lc, lp, pb)
    if ops.device.type == "cpu":
        return EncodeBatch(*range_encode_plain(ops, op_ends, active, out_cap,
                                               lc, lp, pb))
    from . import _build
    fn = _build.library("range_encode").lzt_range_encode
    fn.restype = ctypes.c_int
    fn.argtypes = _LAUNCH_ARGTYPES
    n, n_chunks = op_ends.shape
    op_cap = ops.shape[1]
    stride = scratch_lane_bytes(op_cap, n_chunks)
    dev = ops.device
    with torch.cuda.device(dev):
        bodies = torch.zeros((n, out_cap), dtype=torch.uint8, device=dev)
        tab = torch.zeros((n, n_chunks), dtype=torch.int32, device=dev)
        status = torch.empty((4, n), dtype=torch.int32, device=dev)
        scratch = torch.empty((n, stride), dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for m in marks:       # creates the events; the kernel re-records
            m.record()        # the middle two between its launches
        mid = (ctypes.c_void_p * 2)(marks[1].cuda_event, marks[2].cuda_event)
        rc = fn(ops.data_ptr(), op_cap, op_ends.data_ptr(), n_chunks,
                active.data_ptr(), bodies.data_ptr(), out_cap, tab.data_ptr(),
                *(status[i].data_ptr() for i in range(4)), n, lc, lp, pb,
                scratch.data_ptr(), stride, mid, stream)
        marks[3].record()
    if rc != 0:
        raise RuntimeError(f"range_encode kernel launch failed: CUDA error {rc}")
    launches += 1
    return EncodeBatch(bodies, tab, status, marks, scratch)


def finalize_encode(handle: EncodeBatch, lane_nchunks):
    """Materialize a submitted batch on the host.

    Returns ``(bodies, ok, err)``: bodies[s] is the list of lane s's chunk
    bodies (None where the lane failed), ok a bool and err an int32 numpy
    array [S].  Only the bytes the lanes wrote leave the device."""
    if handle.marks is not None:
        with TRACE.timer("range_encode.wait"):
            handle.marks[-1].synchronize()
        m = handle.marks
        TRACE.add("range_encode.kernel_ms", m[0].elapsed_time(m[-1]))
        for name, a, b in zip(STEPS, m, m[1:]):
            TRACE.add(f"range_encode.{name}_ms", a.elapsed_time(b))
        handle.scratch = None
    with TRACE.timer("range_encode.device_to_host"):
        status = handle.status.cpu().numpy()
        used = int(status[1].max(initial=0))
        flat = handle.bodies[:, :used].cpu().numpy()
        tab = handle.tab.cpu().numpy()
    TRACE.add("range_encode.bytes_written",
              int(status[1].sum()) + 4 * (tab.size + status.size))
    TRACE.peak("range_encode.bit_calls_max", int(status[3].max(initial=0)))
    ok = status[0] != 0
    bodies = []
    for s, nch in enumerate(lane_nchunks):
        if not ok[s]:
            bodies.append(None)
            continue
        ends = [0] + tab[s, :nch].tolist()
        row = flat[s]
        bodies.append([row[a:b].tobytes() for a, b in zip(ends, ends[1:])])
    return bodies, ok, status[2]


def op_bit_calls(op_words) -> np.ndarray:
    """Range-coder bit calls of each op record (direct bits included), as
    the coder makes them: ``op_words`` uint32 [2 * n] -> int64 [n]."""
    w = np.asarray(op_words, np.uint32).astype(np.int64)
    a, b = w[0::2], w[1::2]
    kind, ri, length = a & 3, (a >> 2) & 3, a >> 4
    sym = length - S.MATCH_MIN_LEN
    len_bits = np.where(sym < 8, 4, np.where(sym < 16, 5, 10))  # choices+tree
    slot = _pos_slot(torch.from_numpy(np.where(kind == 1, b, 0))).numpy()
    # posSlot, then spec pos (nd bits) or nd - 4 direct bits and 4 align
    dist_bits = 6 + np.where(slot < 4, 0, (slot >> 1) - 1)
    rep_bits = 3 + np.where(ri >= 2, 2, 1)     # isRepG0, then G1 (+ G2)
    return np.select([kind == 0, kind == 1, kind == 2],
                     [np.full_like(a, 9), 2 + len_bits + dist_bits,
                      rep_bits + len_bits], 4)


def from_jax_batch(ops_words, meta):
    """The JAX package's ``pack_ops_batch`` batch as this module's tensors.

    ops_words int32[op_pages, S, 128] = each lane's op words, page after
    page; meta int32[3, S, 128] = chunk count, active, cumulative op-word
    ends per chunk.  Returns CPU tensors ``(ops, op_ends, active)``; C is the
    largest chunk count."""
    ops_words = np.asarray(ops_words, np.int32)
    meta = np.asarray(meta, np.int32)
    n = meta.shape[1]
    c = max(1, int(meta[0, :, 0].max(initial=0)))
    ops = np.ascontiguousarray(ops_words.transpose(1, 0, 2)).reshape(n, -1)
    return (torch.from_numpy(ops.copy()),
            torch.from_numpy(np.ascontiguousarray(meta[2, :, :c])),
            torch.from_numpy(np.ascontiguousarray(meta[1, :, 0])))


# ---------------------------------------------------------------------------
# plain version: lane-batched lockstep encoder on torch tensors
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_TOP = S.RC_TOP
# the adapted probability after coding a 0 (row 0) or a 1 (row 1)
_NEXT_PROB = torch.tensor(
    [[p + ((S.RC_BIT_MODEL_TOTAL - p) >> S.RC_MOVE_BITS),
      p - (p >> S.RC_MOVE_BITS)] for p in range(S.RC_BIT_MODEL_TOTAL)]).T
# the state after a literal, match, rep and short rep (rows = op kind)
_NEXT_STATE = torch.tensor([
    [S.state_after_literal(s) for s in range(S.NUM_STATES)],
    [S.state_after_match(s) for s in range(S.NUM_STATES)],
    [S.state_after_rep(s) for s in range(S.NUM_STATES)],
    [S.state_after_short_rep(s) for s in range(S.NUM_STATES)]])
# the lengths an op record of each kind may carry
_LEN_MIN = torch.tensor([1, S.MATCH_MIN_LEN, S.MATCH_MIN_LEN, 1])
_LEN_MAX = torch.tensor([1, S.MATCH_MAX_LEN, S.MATCH_MAX_LEN, 1])


class _Coders:
    """The range coders of S lanes (``lzma_enc_lane.cuh``'s ``Coder``), one
    bit, ShiftLow or byte per call for the lanes of a mask.  low is int64
    (33 bits used); the pending 0xFF run of each lane has any length."""

    def __init__(self, out: torch.Tensor, probs: torch.Tensor | None):
        n, self.cap = out.shape
        self.out = out
        self._flat = out.view(-1)
        self._row0 = torch.arange(n, dtype=torch.int64) * self.cap
        self.probs = probs
        self._n_probs = 0 if probs is None else probs.shape[1]
        z = torch.zeros(n, dtype=torch.int64)
        self.low, self.cache, self.opos, self.err, self.bits = z, z, z, z, z
        self.cache_size = z + 1
        self.range = z + _M32

    def reset(self, m):
        """A fresh coder on the lanes of ``m``."""
        self.low = torch.where(m, 0, self.low)
        self.range = torch.where(m, _M32, self.range)
        self.cache = torch.where(m, 0, self.cache)
        self.cache_size = torch.where(m, 1, self.cache_size)

    def put(self, m, byte):
        m = m & (self.err == 0)
        over = m & (self.opos >= self.cap)
        self.err = torch.where(over, ERR_OVERFLOW, self.err)
        w = m & ~over
        if bool(w.any()):
            self._flat[(self._row0 + self.opos)[w]] = byte[w].to(torch.uint8)
            self.opos = self.opos + w.long()

    def shift_low(self, m):
        if not bool(m.any()):
            return
        low = self.low
        final = m & ((low < 0xFF000000) | (low > _M32))
        if bool(final.any()):
            carry = low >> 32
            self.put(final, (self.cache + carry) & 0xFF)
            run = torch.where(final, self.cache_size - 1, 0)
            ff = (0xFF + carry) & 0xFF
            j = 0
            while bool((more := run > j).any()):
                self.put(more, ff)
                j += 1
            self.cache = torch.where(final, (low >> 24) & 0xFF, self.cache)
            self.cache_size = torch.where(final, 0, self.cache_size)
        self.cache_size = self.cache_size + m.long()
        self.low = torch.where(m, (low & 0xFFFFFF) << 8, low)

    def normalize(self, m):
        need = m & (self.range < _TOP)
        if bool(need.any()):
            self.range = torch.where(need, (self.range << 8) & _M32,
                                     self.range)
            self.shift_low(need)

    def bit(self, m, idx, b):
        """One adaptive bit ``b`` (bool or 0/1 per lane) with probability
        ``probs[idx]`` on the lanes of ``m``."""
        if not bool(m.any()):
            return
        if b.dtype != torch.bool:
            b = b != 0
        self.bits = self.bits + (m & (self.err == 0)).long()
        idx = idx.clamp(0, self._n_probs - 1).unsqueeze(1)
        p = self.probs.gather(1, idx).squeeze(1)
        bound = (self.range >> S.RC_BIT_MODEL_TOTAL_BITS) * p
        one = m & b
        self.range = torch.where(one, self.range - bound,
                                 torch.where(m, bound, self.range))
        self.low = self.low + bound * one
        self.probs.scatter_(1, idx, torch.where(m, _NEXT_PROB[b.long(), p],
                                                p).unsqueeze(1))
        self.normalize(m)

    def direct_bits(self, m, v, n):
        """``n`` (per lane) low bits of ``v``, most significant first."""
        if not bool(m.any()):
            return
        for i in range(int(n[m].max()) - 1, -1, -1):
            mi = m & (i < n)
            self.bits = self.bits + (mi & (self.err == 0)).long()
            self.range = torch.where(mi, self.range >> 1, self.range)
            self.low = torch.where(mi & (((v >> i) & 1) == 1),
                                   self.low + self.range, self.low)
            self.normalize(mi)

    def tree(self, m, base, nbits, sym, max_bits: int):
        """Bit tree of ``nbits`` (per lane, <= max_bits) bits of ``sym``,
        most significant first."""
        node = torch.ones_like(base)
        for j in range(max_bits):
            mj = m & (j < nbits)
            b = (sym >> (nbits - 1 - j).clamp(min=0)) & 1
            self.bit(mj, base + node, b)
            node = torch.where(mj, (node << 1) | b, node)

    def tree_reverse(self, m, base, nbits, sym, max_bits: int):
        node = torch.ones_like(base)
        for i in range(max_bits):
            mi = m & (i < nbits)
            b = (sym >> i) & 1
            self.bit(mi, base + node, b)
            node = torch.where(mi, (node << 1) | b, node)


def _pos_slot(dist):
    n = torch.frexp(dist.double())[1].long() - 1     # floor(log2(dist))
    return torch.where(dist < 4, dist,
                       (n << 1) | ((dist >> (n - 1).clamp(min=0)) & 1))


class _Lockstep:
    """Every live lane encodes one op per step; masks keep lanes that take
    another branch, or have stopped, unchanged.  Per lane it follows
    ``csrc/lzma_enc_lane.cuh`` step for step, so bodies, tab and status
    agree with the kernel on every input, failing lanes included."""

    def __init__(self, ops, op_ends, active, out_cap, lc, lp, pb):
        n, self.op_cap = ops.shape
        self.n_chunks = op_ends.shape[1]
        self.ops = ops.long() & _M32
        self.ends = op_ends.long()
        self.lc, self.lp_mask, self.pb_mask = lc, (1 << lp) - 1, (1 << pb) - 1
        probs = torch.full((n, S.num_probs(lc, lp)), S.PROB_INIT,
                           dtype=torch.int64)
        self.rc = _Coders(torch.zeros((n, out_cap), dtype=torch.uint8), probs)
        self.tab = torch.zeros((n, self.n_chunks), dtype=torch.int32)
        z = torch.zeros(n, dtype=torch.int64)
        self.state, self.pos, self.k, self.chunk, self.cur_end = z, z, z, z, z
        self.active = active != 0
        self.live = self.active.clone()
        self.in_chunk = torch.zeros(n, dtype=torch.bool)

    def _set_tab(self, m):
        rows = torch.nonzero(m)[:, 0]
        self.tab[rows, self.chunk[rows]] = self.rc.opos[rows].int()

    # -- chunk transitions -------------------------------------------------
    def _end_chunks(self):
        m = self.live & self.in_chunk & (self.k >= self.cur_end)
        if not bool(m.any()):
            return
        for _ in range(5):
            self.rc.shift_low(m)
        self._set_tab(m & (self.rc.err == 0))
        self.chunk = self.chunk + m.long()
        self.in_chunk = self.in_chunk & ~m

    def _start_chunks(self):
        last = self.n_chunks - 1
        while True:
            self.live = self.live & (self.rc.err == 0)
            m = self.live & ~self.in_chunk
            finished = m & (self.chunk > last)
            self.live = self.live & ~finished
            m = m & ~finished
            if not bool(m.any()):
                return
            end = self.ends.gather(1, self.chunk.clamp(max=last)[:, None])[:, 0]
            bad = m & ((end < self.k) | (end > self.op_cap) | ((end & 1) == 1))
            self.rc.err = torch.where(bad, ERR_TABLE, self.rc.err)
            m = m & ~bad
            empty = m & (end == self.k)
            self._set_tab(empty)
            self.chunk = self.chunk + empty.long()
            start = m & (end > self.k)
            if bool(start.any()):
                self.rc.reset(start)
                self.cur_end = torch.where(start, end, self.cur_end)
                self.in_chunk = self.in_chunk | start
            if not bool((bad | empty).any()):
                return

    # -- ops ---------------------------------------------------------------
    def _op(self, go):
        rc = self.rc
        k = self.k.clamp(max=self.op_cap - 2)[:, None]
        a = self.ops.gather(1, k)[:, 0]
        b = self.ops.gather(1, k + 1)[:, 0]
        kind, ri, length = a & 3, (a >> 2) & 3, a >> 4
        valid = (length >= _LEN_MIN[kind]) & (length <= _LEN_MAX[kind])
        rc.err = torch.where(go & ~valid, ERR_OP, rc.err)
        go = go & valid
        st, pos = self.state, self.pos
        ps = pos & self.pb_mask
        rc.bit(go, S.IS_MATCH + (st << S.NUM_POS_BITS_MAX) + ps, kind != 0)
        lit = go & (kind == 0)
        if bool(lit.any()):
            sym, prev, mb = b & 0xFF, (b >> 8) & 0xFF, (b >> 16) & 0xFF
            base = S.LITERAL + 0x300 * (((pos & self.lp_mask) << self.lc)
                                        + (prev >> (8 - self.lc)))
            offs = torch.where(st >= 7, 0x100, 0)   # matched literal
            node = torch.ones_like(base)
            for i in range(7, -1, -1):
                bb = (sym >> i) & 1
                mb = mb << 1
                bc = mb & offs
                rc.bit(lit, base + offs + bc + node, bb)
                node = (node << 1) | bb
                offs = torch.where(bb == 1, offs & bc, offs & ~bc)
        simple, rep, short = (go & (kind == 1), go & (kind == 2),
                              go & (kind == 3))
        if bool((simple | rep | short).any()):
            r0 = short | (rep & (ri == 0))
            rc.bit(simple | rep | short, S.IS_REP + st, kind != 1)
            rc.bit(rep | short, S.IS_REP_G0 + st, ~r0)
            rc.bit(r0, S.IS_REP0_LONG + (st << S.NUM_POS_BITS_MAX) + ps,
                   kind == 2)
            rc.bit(rep & (ri != 0), S.IS_REP_G1 + st, ri >= 2)
            rc.bit(rep & (ri >= 2), S.IS_REP_G2 + st, ri == 3)
            self._len(simple | rep, torch.where(simple, S.LEN_CODER,
                                                S.REP_LEN_CODER), ps, length)
            self._dist(simple, length, b)
        self.state = torch.where(go, _NEXT_STATE[kind, st], st)
        self.pos = pos + torch.where(go, length, 0)
        self.k = self.k + 2 * go.long()

    def _len(self, m, base, ps, length):
        if not bool(m.any()):
            return
        sym = length - S.MATCH_MIN_LEN
        mid_up, high = sym >= S.LEN_LOW_SYMBOLS, \
            sym >= S.LEN_LOW_SYMBOLS + S.LEN_MID_SYMBOLS
        self.rc.bit(m, base + S.LEN_CHOICE, mid_up)
        self.rc.bit(m & mid_up, base + S.LEN_CHOICE2, high)
        low, mid = ~mid_up, mid_up & ~high
        tbase = torch.where(
            low, base + S.LEN_LOW + (ps << S.LEN_LOW_BITS),
            torch.where(mid, base + S.LEN_MID + (ps << S.LEN_MID_BITS),
                        base + S.LEN_HIGH))
        tsym = torch.where(low, sym, torch.where(mid, sym - S.LEN_LOW_SYMBOLS,
                                                 sym - 16))
        nbits = torch.where(high, S.LEN_HIGH_BITS, S.LEN_LOW_BITS)
        self.rc.tree(m, tbase, nbits, tsym,
                     S.LEN_HIGH_BITS if bool((m & high).any())
                     else S.LEN_LOW_BITS)

    def _dist(self, m, length, dist):
        if not bool(m.any()):
            return
        lt = (length - S.MATCH_MIN_LEN).clamp(max=S.NUM_LEN_TO_POS_STATES - 1)
        slot = _pos_slot(dist)
        self.rc.tree(m, S.POS_SLOT + (lt << S.NUM_POS_SLOT_BITS),
                     torch.full_like(slot, S.NUM_POS_SLOT_BITS), slot,
                     S.NUM_POS_SLOT_BITS)
        nd = ((slot >> 1) - 1).clamp(min=0)
        base = (2 | (slot & 1)) << nd
        rem = dist - base
        spec = m & (slot >= 4) & (slot < S.END_POS_MODEL_INDEX)
        self.rc.tree_reverse(spec, S.SPEC_POS + base - slot - 1, nd, rem, 5)
        far = m & (slot >= S.END_POS_MODEL_INDEX)
        if bool(far.any()):
            self.rc.direct_bits(far, rem >> S.NUM_ALIGN_BITS,
                                nd - S.NUM_ALIGN_BITS)
            self.rc.tree_reverse(far, torch.full_like(rem, S.ALIGN),
                                 torch.full_like(rem, S.NUM_ALIGN_BITS),
                                 rem & (S.ALIGN_TABLE_SIZE - 1),
                                 S.NUM_ALIGN_BITS)

    def run(self):
        while True:
            self._end_chunks()
            self._start_chunks()
            go = self.live & self.in_chunk & (self.k < self.cur_end)
            if bool(go.any()):
                self._op(go)
            elif not bool(self.live.any()):
                break
        err = self.rc.err
        status = torch.stack([
            (~self.active | (err == 0)).int(),
            torch.where(self.active, self.rc.opos, 0).int(),
            torch.where(self.active, err, 0).int(),
            torch.where(self.active, self.rc.bits, 0).int()])
        return self.rc.out, self.tab, status


def range_encode_plain(ops, op_ends, active, out_cap: int, lc: int = 3,
                       lp: int = 0, pb: int = 2):
    """The plain PyTorch version of K2 on CPU tensors.

    Same arguments as ``submit_encode_groups``; returns (bodies uint8
    [S, out_cap], tab int32 [S, C], status int32 [4, S])."""
    return _Lockstep(ops, op_ends, active, out_cap, lc, lp, pb).run()
