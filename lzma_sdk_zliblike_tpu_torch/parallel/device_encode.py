"""LZMA2 encode with work on the GPU: device-coded, hybrid and device-assisted.

The counterpart of the JAX package's ``parallel/device_encode.py``, its
three entry points:

* ``encode_lzma2_device_coded`` (JAX :94-209), the find → parse → code
  pipeline of the reference's LzFindMt.c + MtCoder.c pair: host threads run
  the fast parse of each dict-reset group and export its op records
  (``native.lzma2_group_ops``); kernel K2 (``ops/range_encode.py``)
  range-codes a batch of groups, one lane per group; the host frames the
  chunk bodies and joins the groups in order.
* ``encode_lzma2_hybrid`` (JAX :212-369): host workers and a K2 feeder
  drain one group queue.
* ``encode_lzma2_device`` (JAX :27-72): the match finder X2
  (``ops/match_find.py``, the kernel ``csrc/match_find.cu``) finds each
  position's candidates on the card and the host parse and coder
  (``native.lzma2_encode_ext``) consume them.

The device-coded and hybrid streams are byte-identical to
``host_pool.encode_lzma2_mt`` at the same parameters (``effort=9``),
because K2's bodies equal the native coder's; the device-assisted stream is
byte-identical to the JAX package's ``encode_lzma2_device``.

A group that needs LZMA2 copy chunks (some native body is at least
``min(unpack, 65536)`` bytes) is encoded whole by the host encoder, which
alone writes copy chunks; so is a group too large for K2's launcher
(``on_card``: an op row of ``range_encode.OP_CAP_LIMIT`` words or a body row
of ``OUT_CAP_LIMIT`` bytes).  The choice is made from the parse before the
launch.  A lane the kernel fails, or whose bodies differ from the ones the
parse returned, is a kernel fault and raises: it is not re-encoded on the
host.

**The hybrid encoder** keeps the JAX engine's design: host workers take
whole groups from the front of one deque and encode each with
``native.lzma2_encode``; a feeder thread takes batches of ``lanes`` groups
from the back, parses them on a pool of ``FEEDER_PARSE_THREADS``, packs
them and launches K2; each group's slot is written once, so the output
never depends on the race; groups the card cannot take go back to the
front for the hosts; a group left at the end is encoded on the calling
thread.  It departs from the JAX engine in four ways:

1. *The abstain rule.*  The feeder abstains once fewer than ``lanes``
   eligible groups remain, as the JAX docstring says; the JAX code abstains
   below ``lanes * 8`` (:310), so at its defaults its feeder never runs on
   fewer than 256 groups.  ``lanes`` is capped by the device budget
   (``hybrid_lanes``).
2. *Faults raise.*  A lane K2 fails, or whose bodies differ from the
   parse's, raises ``RuntimeError``; the JAX engine re-queues it to the
   hosts silently.
3. *The feeder is joined, not a daemon.*  On a worker's error the call waits
   for the feeder's current step and then raises, as ``parallel/hybrid.py``
   does: a thread left inside a torch call can abort the interpreter at
   exit.
4. *No fallback.*  The port's native runtime is always built (a failed
   build raises), so there is no host-only branch.

**The device-assisted encoder** sends ``lanes`` chunks of ``chunk_size`` at
a time through X2 on the card, then encodes each chunk's group with
``native.lzma2_encode_ext`` on a thread pool while the card finds the next
batch's candidates; the groups are joined in order with one end byte.  The
JAX function makes one ``lzma2_encode_ext`` call over the whole input, with
an ``ext`` array of 144 bytes per input byte at its defaults; a group's
stream does not depend on the others, so the join gives the same bytes
with ``ext`` held for ``INFLIGHT`` batches only.

``ctypes`` calls release the GIL, so the host work runs in parallel.

Steps and sizes go to ``utils/trace.TRACE``.  Device-coded: timers
``device_encode.parse``, ``.pack_and_host_to_device``, ``.frame_and_join``
(with ``range_encode.wait`` and ``.device_to_host`` from
``finalize_encode``); counters ``device_encode.batches``, ``.host_groups``,
``.lanes``, ``.kernel_bytes_read`` (op words, chunk ends and flags the
kernel reads) and ``.ops_per_lane_max``.  Hybrid: counters
``hybrid_encode.dev_groups``, ``.host_groups``, ``.dev_batches``,
``.dev_abstained`` and ``.returned_to_host``.  Device-assisted: timers
``device_encode.match_find`` (CUDA events around each batch's finder on the
card), ``.x2_device_to_host`` (its candidates' copy to the host),
``.encode_ext`` (each group's host coder) and ``.wait_for_host_coder`` (the
calling thread waiting for the pool); counter ``device_encode.x2_batches``.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..api import check_device
from ..models.lzma2.framing import encode_dict_prop
from ..ops import match_find as X2
from ..ops import range_encode as R
from ..utils.errors import ParamError
from ..utils.memory import INFLIGHT, encode_lanes
from ..utils.trace import TRACE
from .host_pool import normalize_threads

SUB_CHUNK = 48 << 10        # LZMA2 chunk of unpacked bytes (packed < 64 KiB)
COPY_LIMIT = 1 << 16        # a body this large (or >= unpack) needs copy chunks
FEEDER_PARSE_THREADS = 3    # the hybrid feeder's parse pool (JAX :316)


def real_dict_size(prop: int) -> int:
    return 0xFFFFFFFF if prop == 40 else (2 | (prop & 1)) << (prop // 2 + 11)


def needs_copy_chunks(tab) -> bool:
    """Whether a group parsed into ``tab`` ([n_chunks, 3] cumulative op
    words, unpack bytes, body bytes) has a body the host frames as copy
    chunks (``lzt_codec.cc:2052-2088``)."""
    unpack = np.diff(tab[:, 1], prepend=0)
    body = np.diff(tab[:, 2], prepend=0)
    return bool((body >= np.minimum(unpack, COPY_LIMIT)).any())


def on_card(ops, span) -> bool:
    """Whether the kernel's launcher takes a lane of a group of ``ops`` op
    words over ``span`` (start, end) bytes of input."""
    start, end = span
    return (R.op_row_words(len(ops)) < R.OP_CAP_LIMIT
            and R.out_cap_for(end - start) < R.OUT_CAP_LIMIT)


def frame_group(bodies, start: int, end: int, sub: int, props_byte: int) -> bytes:
    """LZMA2 chunk headers around one group's chunk bodies (the framing of
    ``lzma2_encode_impl``): the first chunk resets the dictionary, state and
    props, the others continue."""
    out = bytearray()
    pos = start
    for j, body in enumerate(bodies):
        cend = min(pos + sub, end)
        unpack = cend - pos
        if len(body) >= min(unpack, COPY_LIMIT):
            raise RuntimeError(f"chunk body of {len(body)} bytes for {unpack} "
                               "unpacked: the kernel's body disagrees with "
                               "the native coder's")
        mode = 3 if j == 0 else 0
        u = unpack - 1
        out += bytes([0x80 | (mode << 5) | (u >> 16), (u >> 8) & 0xFF, u & 0xFF,
                      (len(body) - 1) >> 8, (len(body) - 1) & 0xFF])
        if mode >= 2:
            out.append(props_byte)
        out += body
        pos = cend
    return bytes(out)


def group_spans(n: int, chunk_size: int) -> list[tuple[int, int]]:
    return [(i, min(i + chunk_size, n)) for i in range(0, n, chunk_size)]


def parse_group(data: bytes, span, dict_size: int, sub: int, lc: int,
                lp: int, pb: int):
    """The fast parse of one dict-reset group: (ops, chunk table, native
    bodies), ``native.lzma2_group_ops`` in chunks of ``sub`` bytes."""
    start, end = span
    return native.lzma2_group_ops(
        data[start:end], real_dict_size(encode_dict_prop(dict_size)),
        lc=lc, lp=lp, pb=pb, sub_size=sub)


def host_group(data: bytes, span, dict_size: int, chunk_size: int, lc: int,
               lp: int, pb: int) -> bytes:
    """One dict-reset group encoded whole by the host encoder, without the
    end byte."""
    start, end = span
    stream, _ = native.lzma2_encode(data[start:end], dict_size, chunk_size,
                                    lc=lc, lp=lp, pb=pb)
    return stream[:-1]


def card_groups(parsed, spans) -> list[bool]:
    """For each parsed group, whether K2 codes it: no copy chunks, and
    within the launcher's limits."""
    return [not needs_copy_chunks(p[1]) and on_card(p[0], s)
            for p, s in zip(parsed, spans)]


def submit_batch(parsed, device, lc: int, lp: int, pb: int):
    """Pack the groups' op records into one batch and launch K2 on it.
    Returns the handle and each lane's chunk count."""
    with TRACE.timer("device_encode.pack_and_host_to_device"):
        ops, op_ends, active, out_cap, nch = R.pack_ops_batch(
            [p[0] for p in parsed], [p[1] for p in parsed])
        tensors = [x.to(device) for x in (ops, op_ends, active)]
    TRACE.add("device_encode.batches")
    TRACE.add("device_encode.lanes", len(parsed))
    TRACE.add("device_encode.kernel_bytes_read", 4 * (
        int(op_ends[:, -1].sum()) + op_ends.numel() + len(parsed)))
    TRACE.peak("device_encode.ops_per_lane_max",
               max(len(p[0]) for p in parsed) // 2)
    handle = R.submit_encode_groups(*tensors, out_cap=out_cap, lc=lc, lp=lp,
                                    pb=pb)
    return handle, nch


def finish_batch(handle, nch, groups, parsed, spans, sub: int,
                 props_byte: int) -> list[bytes]:
    """Wait for a submitted batch and frame each lane's bodies as its
    group's LZMA2 chunks.  A lane the kernel failed, or whose bodies differ
    from the parse's, raises ``RuntimeError`` (a kernel fault)."""
    bodies, ok, err = R.finalize_encode(handle, nch)
    out = []
    with TRACE.timer("device_encode.frame_and_join"):
        for li, (gi, p, span) in enumerate(zip(groups, parsed, spans)):
            if not ok[li]:
                raise RuntimeError(
                    f"range-encode kernel failed dict-reset group {gi} "
                    f"(err {int(err[li])}) that the host parsed: a "
                    "kernel fault")
            if b"".join(bodies[li]) != p[2]:
                raise RuntimeError(
                    f"range-encode kernel's bodies for dict-reset group "
                    f"{gi} differ from the parse's: a kernel fault")
            out.append(frame_group(bodies[li], *span, sub, props_byte))
    return out


def encode_lzma2_device_coded(data: bytes, *, dict_size: int = 1 << 20,
                              chunk_size: int = 1 << 20,
                              lanes: int | None = None,
                              threads: int | None = None, lc: int = 3,
                              lp: int = 0, pb: int = 2, progress=None,
                              device="cuda") -> tuple[bytes, int]:
    """LZMA2 encode with the range-coding stage on ``device``.

    Returns ``(stream, dict_prop)``, byte-identical to
    ``host_pool.encode_lzma2_mt`` at the same parameters.  ``device="cuda"``
    (the default) codes with kernel K2 and raises when there is no card;
    ``device="cpu"`` runs the kernel's plain PyTorch version.  Batches are
    sized by the device budget (``utils/memory.encode_lanes``) and hold at
    most ``lanes`` groups (None: no cap), at most ``INFLIGHT`` on the card;
    ``progress(in_bytes, out_bytes)`` is called after each batch.  The
    stream does not depend on ``lanes``."""
    device = check_device(device)
    if lanes is not None and lanes < 1:
        raise ParamError(f"lanes must be at least 1, got {lanes}")
    prop = encode_dict_prop(dict_size)
    n = len(data)
    if n == 0:
        return b"\x00", prop
    spans = group_spans(n, chunk_size)
    sub = min(SUB_CHUNK, chunk_size)
    props_byte = (pb * 5 + lp) * 9 + lc
    results: list[bytes | None] = [None] * len(spans)

    def finish(handle, batch, lane_nchunks):
        framed = finish_batch(handle, lane_nchunks, batch,
                              [parsed[gi] for gi in batch],
                              [spans[gi] for gi in batch], sub, props_byte)
        for gi, part in zip(batch, framed):
            results[gi] = part
        if progress is not None:
            progress(sum(e - s for (s, e), r in zip(spans, results) if r),
                     sum(len(r) for r in results if r))

    with ThreadPoolExecutor(normalize_threads(threads, len(spans))) as pool:
        with TRACE.timer("device_encode.parse"):
            parsed = list(pool.map(
                lambda s: parse_group(data, s, dict_size, sub, lc, lp, pb),
                spans))
        card = card_groups(parsed, spans)
        host = [gi for gi, c in enumerate(card) if not c]
        host_parts = pool.map(
            lambda gi: host_group(data, spans[gi], dict_size, chunk_size,
                                  lc, lp, pb), host)
        TRACE.add("device_encode.host_groups", len(host))
        dev = [gi for gi, c in enumerate(card) if c]
        if dev:
            width = encode_lanes(
                min(len(dev), lanes or len(dev)),
                max(len(parsed[gi][0]) for gi in dev),
                R.out_cap_for(max(spans[gi][1] - spans[gi][0] for gi in dev)),
                max(len(parsed[gi][1]) for gi in dev), device=device)
            pending: collections.deque = collections.deque()
            for base in range(0, len(dev), width):
                batch = dev[base:base + width]
                if len(pending) == INFLIGHT:
                    finish(*pending.popleft())
                handle, nch = submit_batch([parsed[gi] for gi in batch],
                                           device, lc, lp, pb)
                pending.append((handle, batch, nch))
            while pending:
                finish(*pending.popleft())
        for gi, part in zip(host, host_parts):
            results[gi] = part
    with TRACE.timer("device_encode.frame_and_join"):
        return b"".join(results) + b"\x00", prop  # type: ignore[arg-type]


def hybrid_lanes(lanes: int, chunk_size: int, device) -> int:
    """The hybrid feeder's batch width: ``lanes``, capped by the device
    budget for groups of ``chunk_size`` bytes at the most op words and
    chunks such a group can parse into."""
    sub = min(SUB_CHUNK, chunk_size)
    return encode_lanes(lanes, native.group_ops_cap(chunk_size),
                        R.out_cap_for(chunk_size), -(-chunk_size // sub),
                        device=device)


def encode_lzma2_hybrid(data: bytes, *, dict_size: int = 1 << 20,
                        chunk_size: int = 1 << 20, lanes: int = 32,
                        threads: int | None = None, lc: int = 3, lp: int = 0,
                        pb: int = 2, device="cuda") -> tuple[bytes, int]:
    """Host cores and K2 on ``device`` drain one group queue.

    Returns ``(stream, dict_prop)``, byte-identical to
    ``host_pool.encode_lzma2_mt`` at the same parameters whoever encodes
    each group.  ``threads`` host workers (None or 0: every core, at most
    one per group) take groups from the front; the feeder takes batches of
    ``lanes`` (capped by the device budget) from the back while at least
    that many groups it may take remain.  ``device="cuda"`` (the default)
    raises when there is no card; ``device="cpu"`` feeds K2's plain PyTorch
    version."""
    device = check_device(device)
    prop = encode_dict_prop(dict_size)
    n = len(data)
    if n == 0:
        return b"\x00", prop
    spans = group_spans(n, chunk_size)
    sub = min(SUB_CHUNK, chunk_size)
    props_byte = (pb * 5 + lp) * 9 + lc
    lanes = hybrid_lanes(lanes, chunk_size, device)
    results: list[bytes | None] = [None] * len(spans)
    lock = threading.Lock()
    todo: collections.deque[int] = collections.deque(range(len(spans)))
    no_device: set[int] = set()     # groups the feeder gave back
    errors: list[Exception] = []

    def host_one(gi: int) -> None:
        results[gi] = host_group(data, spans[gi], dict_size, chunk_size,
                                 lc, lp, pb)
        TRACE.add("hybrid_encode.host_groups")

    def host_worker():
        while True:
            with lock:
                if errors or not todo:
                    return
                gi = todo.popleft()
            try:
                host_one(gi)
            except Exception as e:  # noqa: BLE001 - reported by the call
                with lock:
                    errors.append(e)
                return

    def take_batch() -> list[int]:
        with lock:
            if errors:
                return []
            eligible = [gi for gi in todo if gi not in no_device]
            if len(eligible) < lanes:
                TRACE.add("hybrid_encode.dev_abstained")
                return []
            batch = eligible[-lanes:]
            for gi in batch:
                todo.remove(gi)
        return batch

    def device_feeder():
        try:
            with ThreadPoolExecutor(FEEDER_PARSE_THREADS) as ppool:
                while batch := take_batch():
                    parsed = list(ppool.map(
                        lambda gi: parse_group(data, spans[gi], dict_size,
                                               sub, lc, lp, pb), batch))
                    card = card_groups(parsed, [spans[gi] for gi in batch])
                    back = [gi for gi, c in zip(batch, card) if not c]
                    if back:
                        with lock:
                            no_device.update(back)
                            todo.extendleft(back)
                        TRACE.add("hybrid_encode.returned_to_host", len(back))
                    lanes_in = [(gi, p) for gi, p, c in zip(batch, parsed, card)
                                if c]
                    if not lanes_in:
                        continue
                    groups = [gi for gi, _ in lanes_in]
                    lane_parsed = [p for _, p in lanes_in]
                    handle, nch = submit_batch(lane_parsed, device, lc, lp, pb)
                    framed = finish_batch(handle, nch, groups, lane_parsed,
                                          [spans[gi] for gi in groups], sub,
                                          props_byte)
                    for gi, part in zip(groups, framed):
                        results[gi] = part
                    TRACE.add("hybrid_encode.dev_batches")
                    TRACE.add("hybrid_encode.dev_groups", len(groups))
        except Exception as e:  # noqa: BLE001 - reported by the call
            with lock:
                errors.append(e)

    if device.type == "cuda":
        # load the CUDA library before the workers start, so that no build
        # or load lands in the feeder's first batch
        from ..ops import _build
        _build.library("range_encode")
    workers = [threading.Thread(target=host_worker)
               for _ in range(normalize_threads(threads, len(spans)))]
    feeder = threading.Thread(target=device_feeder)
    for w in workers:
        w.start()
    feeder.start()
    for w in workers:
        w.join()
    # after a worker's error the feeder stops at its next step; the call
    # waits for it either way, so no thread outlives the call
    feeder.join()
    if errors:
        raise errors[0]
    for gi, r in enumerate(results):
        if r is None:     # given back after the hosts had left
            host_one(gi)
    return b"".join(results) + b"\x00", prop  # type: ignore[arg-type]


def encode_lzma2_device(data: bytes, *, dict_size: int = 1 << 16,
                        chunk_size: int = 1 << 16, lanes: int = 32,
                        n_cand: int = 24, lc: int = 3, lp: int = 0,
                        pb: int = 2, effort: int = 9,
                        device="cuda") -> tuple[bytes, int]:
    """LZMA2 encode in dict-reset groups of ``chunk_size`` (a power of two)
    with match candidates from X2 on ``device``; returns (stream, prop).

    Each batch of ``lanes`` groups goes through X2 (``n_cand`` 4-byte and
    ``max(1, n_cand // 2)`` 8-byte bucket candidates per position), then its
    groups are encoded by ``native.lzma2_encode_ext`` on a pool of every
    core while the card finds the next batch's candidates; at most
    ``INFLIGHT`` batches of candidates wait on the host.  The stream is
    byte-identical to the JAX package's ``encode_lzma2_device``.
    ``device="cuda"`` (the default) raises when there is no card;
    ``device="cpu"`` runs X2 on the CPU."""
    if chunk_size & (chunk_size - 1):
        raise ValueError("chunk_size must be a power of two")
    device = check_device(device)
    dict_size = max(dict_size, chunk_size)
    n = len(data)
    if n == 0:
        return native.lzma2_encode(data, dict_size, chunk_size, lc=lc, lp=lp,
                                   pb=pb, effort=effort)
    n_cand8 = max(1, n_cand // 2)
    hash_bits = X2.default_hash_bits(chunk_size)
    arr = np.frombuffer(data, np.uint8)
    spans = group_spans(n, chunk_size)
    parts: list[bytes | None] = [None] * len(spans)

    def find(base: int, hi: int) -> np.ndarray:
        """X2 on groups [base, hi): candidates int32 [hi - base, L, K]."""
        rows = np.zeros((hi - base, chunk_size), np.uint8)
        a, b = spans[base][0], spans[hi - 1][1]
        rows.reshape(-1)[:b - a] = arr[a:b]
        valid = np.array([e - s for s, e in spans[base:hi]], np.int32)
        t0 = time.monotonic()
        marks = None
        if device.type == "cuda":
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            marks[0].record()
        _bl, _bd, cands = X2.find_matches_tensor(
            torch.from_numpy(rows).to(device),
            torch.from_numpy(valid).to(device), n_cand=n_cand,
            n_cand8=n_cand8, hash_bits=hash_bits)
        # [S, L, K]: the kernel's own storage, so no copy on the card (the
        # plain version on the CPU gives [S, K, L] and is copied here)
        ext = cands.permute(0, 2, 1).contiguous()
        del cands
        if marks is not None:
            marks[1].record()
            with TRACE.timer("device_encode.x2_device_to_host"):
                # into page-locked memory (PyTorch caches the blocks), which
                # the copy engine writes at the link's rate
                host = torch.empty(ext.shape, dtype=ext.dtype,
                                   pin_memory=True)
                host.copy_(ext)
            ext = host
        TRACE.record("device_encode.match_find",
                     marks[0].elapsed_time(marks[1]) / 1e3 if marks
                     else time.monotonic() - t0)
        TRACE.add("device_encode.x2_batches")
        return ext.numpy()

    def encode_group(gi: int, ext: np.ndarray) -> None:
        start, end = spans[gi]
        with TRACE.timer("device_encode.encode_ext"):
            stream, _ = native.lzma2_encode_ext(
                data[start:end], ext, dict_size, chunk_size, lc=lc, lp=lp,
                pb=pb, effort=effort)
        parts[gi] = stream[:-1]

    pending: collections.deque = collections.deque()
    with ThreadPoolExecutor(normalize_threads(None, len(spans))) as pool:
        for base in range(0, len(spans), lanes):
            hi = min(base + lanes, len(spans))
            ext = find(base, hi)
            if len(pending) == INFLIGHT:
                with TRACE.timer("device_encode.wait_for_host_coder"):
                    for f in pending.popleft():
                        f.result()
            pending.append([
                pool.submit(encode_group, gi,
                            ext[gi - base, :spans[gi][1] - spans[gi][0]])
                for gi in range(base, hi)])
        with TRACE.timer("device_encode.wait_for_host_coder"):
            for futs in pending:
                for f in futs:
                    f.result()
    return (b"".join(parts) + b"\x00",  # type: ignore[arg-type]
            encode_dict_prop(dict_size))
