"""Host-side block-parallel encoding — the MtCoder equivalent.

The counterpart of the JAX package's ``parallel/host_pool.py`` (its encode
half).  The reference's MtCoder splits input into blocks, compresses them
on up to 32 threads, and emits results in order via read/write token rings
(``MtCoder.c:185-224``).  Here: dict-reset groups are encoded concurrently
on a thread pool (the native engine releases the GIL inside ctypes calls)
and joined in submission order.  Thread-count normalization mirrors
``Lzma2EncProps_Normalize`` (``Lzma2Enc.c:176-221``): block threads are
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
                    threads: int | None = None, lc: int = 3, lp: int = 0,
                    pb: int = 2, progress=None) -> tuple[bytes, int]:
    """Parallel LZMA2 encode at effort 9: each dict-reset group is one work
    item.

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
            data[start:end], dict_size, chunk_size, lc=lc, lp=lp, pb=pb)
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
