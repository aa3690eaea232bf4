"""Host-side block-parallel encoding and decoding — the MtCoder equivalent.

The counterpart of the JAX package's ``parallel/host_pool.py``.  The
reference's MtCoder splits input into blocks, compresses them on up to 32
threads, and emits results in order via read/write token rings
(``MtCoder.c:185-224``).  Here: dict-reset groups are encoded or decoded
concurrently on a thread pool (the native engine releases the GIL inside
ctypes calls) and joined in submission order.  Thread-count normalization
mirrors ``Lzma2EncProps_Normalize`` (``Lzma2Enc.c:176-221``): block threads are
capped at 32 and at the number of blocks.  It runs on the port's own native
runtime (``native.py``) and has no pure-Python fallback.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

MAX_BLOCK_THREADS = 32  # MtCoder ring size (MtCoder.h:30-34)


def normalize_threads(threads: int | None, n_blocks: int) -> int:
    if threads is None or threads <= 0:
        threads = os.cpu_count() or 1
    return max(1, min(threads, MAX_BLOCK_THREADS, n_blocks))


def encode_lzma2_mt(data: bytes, *, dict_size: int, chunk_size: int,
                    threads: int | None = None, effort: int = 9,
                    lc: int = 3, lp: int = 0, pb: int = 2,
                    progress=None) -> tuple[bytes, int]:
    """Parallel LZMA2 encode: each dict-reset group is one work item.

    Returns ``(stream, dict_prop)``; output is byte-identical to the
    single-threaded parallel-groups encoder (same groups, same coder), so
    thread count never changes the stream.  ``progress(in_bytes, out_bytes)``
    is called after each group; returning False raises ``ProgressAborted``.
    """
    from .. import native
    from ..models.lzma2.framing import encode_dict_prop
    from ..utils.errors import ProgressAborted

    n = len(data)
    blocks = [(i, min(i + chunk_size, n)) for i in range(0, n, chunk_size)]
    if not blocks:
        return b"\x00", encode_dict_prop(dict_size)
    nt = normalize_threads(threads, len(blocks))
    prop_holder = {}

    def encode_block(span):
        start, end = span
        stream, prop = native.lzma2_encode(
            data[start:end], dict_size, chunk_size, lc=lc, lp=lp, pb=pb,
            effort=effort)
        prop_holder.setdefault("prop", prop)
        return stream[:-1]  # strip the per-call end byte

    out = bytearray()
    done = 0
    with ThreadPoolExecutor(max_workers=nt) as pool:
        # ordered gather: map preserves order
        for (start, end), part in zip(blocks, pool.map(encode_block, blocks)):
            out += part
            done += end - start
            if progress is not None and progress(done, len(out)) is False:
                raise ProgressAborted()
    out.append(0)  # end byte
    return bytes(out), prop_holder["prop"]


def group_span(stream: bytes, group) -> tuple[int, int, int]:
    """(start, end, unpack) byte span of a dict-reset group in ``stream``.

    The span starts at the group's first control byte, so the slice is a
    standalone LZMA2 stream but for the end byte."""
    from ..models.lzma2 import framing

    def ctrl_off(c):
        if not c.is_lzma:
            return c.data_off - 3
        return c.data_off - 5 - (
            1 if c.mode >= framing.MODE_STATE_PROPS else 0)

    return (ctrl_off(group[0]),
            group[-1].data_off + group[-1].pack_size,
            sum(c.unpack_size for c in group))


def decode_group_native(stream: bytes, group, dict_prop: int) -> bytes:
    """Decode one dict-reset group with the native decoder (host worker)."""
    from .. import native

    start, end, unpack = group_span(stream, group)
    return native.lzma2_decode(stream[start:end] + b"\x00", dict_prop,
                               size_hint=unpack)


def decode_lzma2_mt(stream: bytes, dict_prop: int, *,
                    threads: int | None = None, progress=None) -> bytes:
    """Parallel LZMA2 decode: dict-reset groups decoded concurrently.

    Each group starts with a dictionary reset, so every worker runs the
    native decoder on its slice of the stream and the ordered join
    reassembles the output.  ``progress(in_bytes, out_bytes)`` is called at
    each group's ordered completion (``ICompressProgress``,
    ``Types.h:220-225``); returning False cancels the groups not yet
    started and raises ``ProgressAborted``.
    """
    from ..models.lzma2 import framing
    from ..utils.errors import ProgressAborted

    framing.decode_dict_prop(dict_prop)  # validate
    groups = framing.split_groups(framing.scan(stream)[0])
    spans = [group_span(stream, g) for g in groups]
    out = bytearray()
    with ThreadPoolExecutor(normalize_threads(threads,
                                              max(len(spans), 1))) as pool:
        futures = [pool.submit(decode_group_native, stream, g, dict_prop)
                   for g in groups]
        for (_start, end, _u), fut in zip(spans, futures):
            out += fut.result()   # ordered join (the write token)
            if progress is not None and progress(end, len(out)) is False:
                for f in futures:
                    f.cancel()
                raise ProgressAborted()
    return bytes(out)
