"""Device-coded LZMA2 encode: host fast parse, range coding on the GPU.

The counterpart of the JAX package's
``parallel/device_encode.encode_lzma2_device_coded`` (``device_encode.py:94-209``),
the find → parse → code pipeline of the reference's LzFindMt.c + MtCoder.c
pair: host threads run the fast parse of each dict-reset group and export
its op records (``native.lzma2_group_ops``); kernel K2
(``ops/range_encode.py``) range-codes a batch of groups, one lane per group;
the host frames the chunk bodies and joins the groups in order.  The stream
is byte-identical to ``host_pool.encode_lzma2_mt`` at the same parameters
(``effort=9``), because the kernel's bodies equal the native coder's.

A group that needs LZMA2 copy chunks (some native body is at least
``min(unpack, 65536)`` bytes) is encoded whole by the host encoder, which
alone writes copy chunks; the choice is made from the parse's body column
before the launch (``device_encode.host_groups`` counts them).  A lane the
kernel fails, or whose bodies differ from the ones the parse returned, is a
kernel fault and raises: it is not re-encoded on the host.

``ctypes`` calls release the GIL, so the parse runs in parallel on the pool.

Steps and sizes go to ``utils/trace.TRACE``: timers ``device_encode.parse``,
``.pack_and_host_to_device``, ``.frame_and_join`` (with
``range_encode.wait`` and ``.device_to_host`` from ``finalize_encode``);
counters ``device_encode.batches``, ``.host_groups``, ``.lanes``,
``.kernel_bytes_read`` (op words, chunk ends and flags the kernel reads)
and ``.ops_per_lane_max``.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..models.lzma2.framing import encode_dict_prop
from ..ops import range_encode as R
from ..utils.errors import UnsupportedError
from ..utils.memory import INFLIGHT, encode_lanes
from ..utils.trace import TRACE
from .host_pool import normalize_threads

SUB_CHUNK = 48 << 10        # LZMA2 chunk of unpacked bytes (packed < 64 KiB)
COPY_LIMIT = 1 << 16        # a body this large (or >= unpack) needs copy chunks


def real_dict_size(prop: int) -> int:
    return 0xFFFFFFFF if prop == 40 else (2 | (prop & 1)) << (prop // 2 + 11)


def needs_copy_chunks(tab) -> bool:
    """Whether a group parsed into ``tab`` ([n_chunks, 3] cumulative op
    words, unpack bytes, body bytes) has a body the host frames as copy
    chunks (``lzt_codec.cc:2052-2088``)."""
    unpack = np.diff(tab[:, 1], prepend=0)
    body = np.diff(tab[:, 2], prepend=0)
    return bool((body >= np.minimum(unpack, COPY_LIMIT)).any())


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


def encode_lzma2_device_coded(data: bytes, *, dict_size: int = 1 << 20,
                              chunk_size: int = 1 << 20,
                              threads: int | None = None, lc: int = 3,
                              lp: int = 0, pb: int = 2, progress=None,
                              device="cuda") -> tuple[bytes, int]:
    """LZMA2 encode with the range-coding stage on ``device``.

    Returns ``(stream, dict_prop)``, byte-identical to
    ``host_pool.encode_lzma2_mt`` at the same parameters.  ``device="cuda"``
    (the default) codes with kernel K2 and raises when there is no card;
    ``device="cpu"`` runs the kernel's plain PyTorch version.  Batches are
    sized by the device budget (``utils/memory.encode_lanes``), at most
    ``INFLIGHT`` on the card; ``progress(in_bytes, out_bytes)`` is called
    after each batch."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise UnsupportedError("no CUDA device; pass device='cpu' to run the "
                               "plain range encoder on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise UnsupportedError(f"unsupported device {device}")
    prop = encode_dict_prop(dict_size)
    n = len(data)
    if n == 0:
        return b"\x00", prop
    spans = [(i, min(i + chunk_size, n)) for i in range(0, n, chunk_size)]
    sub = min(SUB_CHUNK, chunk_size)
    props_byte = (pb * 5 + lp) * 9 + lc
    results: list[bytes | None] = [None] * len(spans)

    def parse_group(span):
        start, end = span
        return native.lzma2_group_ops(data[start:end], real_dict_size(prop),
                                      lc=lc, lp=lp, pb=pb, sub_size=sub)

    def host_group(span):
        start, end = span
        stream, _ = native.lzma2_encode(data[start:end], dict_size,
                                        chunk_size, lc=lc, lp=lp, pb=pb)
        return stream[:-1]

    def finish(handle, batch, lane_nchunks):
        bodies, ok, err = R.finalize_encode(handle, lane_nchunks)
        with TRACE.timer("device_encode.frame_and_join"):
            for li, gi in enumerate(batch):
                if not ok[li]:
                    raise RuntimeError(
                        f"range-encode kernel failed dict-reset group {gi} "
                        f"(err {int(err[li])}) that the host parsed: a "
                        "kernel fault")
                if b"".join(bodies[li]) != parsed[gi][2]:
                    raise RuntimeError(
                        f"range-encode kernel's bodies for dict-reset group "
                        f"{gi} differ from the parse's: a kernel fault")
                results[gi] = frame_group(bodies[li], *spans[gi], sub,
                                          props_byte)
        if progress is not None:
            progress(sum(e - s for (s, e), r in zip(spans, results) if r),
                     sum(len(r) for r in results if r))

    with ThreadPoolExecutor(normalize_threads(threads, len(spans))) as pool:
        with TRACE.timer("device_encode.parse"):
            parsed = list(pool.map(parse_group, spans))
        host = [gi for gi, p in enumerate(parsed) if needs_copy_chunks(p[1])]
        host_parts = pool.map(host_group, [spans[gi] for gi in host])
        TRACE.add("device_encode.host_groups", len(host))
        dev = sorted(set(range(len(spans))) - set(host))
        if dev:
            lanes = encode_lanes(
                len(dev), max(len(parsed[gi][0]) for gi in dev),
                R.out_cap_for(max(e - s for s, e in spans)), device=device)
            pending: collections.deque = collections.deque()
            for base in range(0, len(dev), lanes):
                batch = dev[base:base + lanes]
                if len(pending) == INFLIGHT:
                    finish(*pending.popleft())
                with TRACE.timer("device_encode.pack_and_host_to_device"):
                    ops, op_ends, active, out_cap, nch = R.pack_ops_batch(
                        [parsed[gi][0] for gi in batch],
                        [parsed[gi][1] for gi in batch])
                    tensors = [x.to(device) for x in (ops, op_ends, active)]
                TRACE.add("device_encode.batches")
                TRACE.add("device_encode.lanes", len(batch))
                TRACE.add("device_encode.kernel_bytes_read", 4 * (
                    int(op_ends[:, -1].sum()) + op_ends.numel() + len(batch)))
                TRACE.peak("device_encode.ops_per_lane_max",
                           max(len(parsed[gi][0]) for gi in batch) // 2)
                handle = R.submit_encode_groups(
                    *tensors, out_cap=out_cap, lc=lc, lp=lp, pb=pb)
                pending.append((handle, batch, nch))
            while pending:
                finish(*pending.popleft())
        for gi, part in zip(host, host_parts):
            results[gi] = part
    with TRACE.timer("device_encode.frame_and_join"):
        return b"".join(results) + b"\x00", prop  # type: ignore[arg-type]
