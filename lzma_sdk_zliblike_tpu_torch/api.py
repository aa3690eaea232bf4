"""Zlib-like one-call API of the PyTorch/CUDA port.

The counterpart of the JAX package's ``api.py``.  The reference exposes it
as ``LzmaCompress``/``LzmaUncompress`` (``LzmaLib.h:98-129``): flat-buffer
one-call raw LZMA with the 5 props bytes carried out-of-band
(``compress``/``uncompress``, host only: one stream has no groups for a
device to share), plus LZMA2 one-calls whose dict-reset groups are the
device's unit.  ``lzma2_compress`` encodes on the host (one thread, or
``threads`` over the groups), ``lzma2_compress_stream`` / ``_file`` in
O(dict) memory; ``lzma2_uncompress`` decodes with the port's three engines:
the group-decode kernel K1 alone under the budget-sized batch shape
(``"device"``), host threads and K1 on one group queue (``"hybrid"``), and
host threads alone (``"host"``).
"""

from __future__ import annotations

import torch

from .models.lzma.spec import LzmaProps
from .utils.errors import ProgressAborted, UnsupportedError
from .utils.trace import TRACE

ENGINES = ("device", "hybrid", "host")


def check_device(device) -> torch.device:
    """``device`` as a torch.device the kernels run on; raises
    UnsupportedError for another type, or for CUDA with no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise UnsupportedError("no CUDA device; pass device='cpu' to run the "
                               "kernels' plain versions on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise UnsupportedError(f"unsupported device {device}")
    return device


def compress(data: bytes, *, level: int = 5, dict_size: int | None = None,
             lc: int = 3, lp: int = 0, pb: int = 2, effort: int | None = None,
             engine: str = "auto") -> tuple[bytes, bytes]:
    """Compress to raw LZMA; returns ``(stream, props_bytes)``.

    Mirrors ``LzmaCompress`` (``LzmaLib.h:98-112``): the props travel
    out-of-band.  ``effort`` defaults from ``level`` (``default_effort``).
    ``engine``: ``"auto"``/``"native"`` or ``"python"`` (``engine.py``); a
    device engine name raises UnsupportedError."""
    from .engine import lzma_raw_encode
    if dict_size is None:
        dict_size = default_dict_size(level)
    if effort is None:
        effort = default_effort(level)
    props = LzmaProps(lc=lc, lp=lp, pb=pb, dict_size=dict_size)
    return (lzma_raw_encode(data, props, effort=effort, engine=engine),
            props.to_bytes())


def uncompress(stream: bytes, props_bytes: bytes, unpack_size: int,
               *, engine: str = "auto") -> bytes:
    """Decompress raw LZMA (``LzmaUncompress``, ``LzmaLib.h:114-129``);
    engines as for ``compress``."""
    from .engine import lzma_raw_decode
    return lzma_raw_decode(stream, LzmaProps.from_bytes(props_bytes),
                           unpack_size, engine=engine)


def lzma2_compress(data: bytes, *, level: int = 5,
                   dict_size: int | None = None,
                   chunk_size: int | None = None,
                   threads: int | None = None,
                   effort: int | None = None,
                   progress=None,
                   props=None,
                   engine: str = "auto") -> tuple[bytes, int]:
    """Compress to a raw LZMA2 stream on the host; returns ``(stream,
    dict_prop)``.

    ``threads`` (other than None and 1, with the native engine): the
    dict-reset groups encode on a thread pool
    (``parallel/host_pool.encode_lzma2_mt``, the MtCoder equivalent; the
    stream is the same at any thread count), with ``progress(done_bytes,
    out_bytes)`` after each group (False aborts with ProgressAborted).
    ``effort``: <= 9 greedy/lazy, 10+ BT4 + optimal parse (defaults from
    ``level``, ``LzmaEnc.c:53-74``).  ``props``: a ``utils.props.EncProps``;
    explicit keywords override its fields.  ``engine``: ``"auto"`` /
    ``"native"`` or ``"python"`` (``framing.encode``); a device engine name
    raises UnsupportedError (the device encoders are
    ``encode_lzma2_device_coded`` and its siblings)."""
    from .engine import check_engine
    from .models.lzma2 import framing
    check_engine(engine)
    if props is not None:
        p = props.normalize()
        dict_size = p.dict_size if dict_size is None else dict_size
        chunk_size = p.chunk_size if chunk_size is None else chunk_size
        effort = p.effort if effort is None else effort
        threads = p.num_block_threads if threads is None else threads
    if dict_size is None:
        dict_size = default_dict_size(level)
    if effort is None:
        effort = default_effort(level)
    if threads is not None and threads != 1 and engine != "python":
        from .parallel.host_pool import encode_lzma2_mt
        return encode_lzma2_mt(data, dict_size=dict_size,
                               chunk_size=chunk_size or (1 << 20),
                               threads=threads, effort=effort,
                               progress=progress)
    return framing.encode(data, dict_size=dict_size, chunk_size=chunk_size,
                          effort=effort, engine=engine)


def lzma2_compress_stream(*, level: int = 5, dict_size: int | None = None,
                          lc: int = 3, lp: int = 0, pb: int = 2,
                          effort: int | None = None):
    """An incremental LZMA2 encoder in O(dict) memory
    (``native.Lzma2StreamEncoder``): ``compress(bytes) -> bytes``,
    ``flush() -> bytes`` and ``dict_prop``.  The streaming counterpart of
    the reference's ``LzmaEnc_Encode2`` sliding-window loop
    (``LzmaEnc.c:2154-2184``, ``LzFind.c:57-121``)."""
    from .native import Lzma2StreamEncoder
    if dict_size is None:
        dict_size = default_dict_size(level)
    if effort is None:
        effort = default_effort(level)
    return Lzma2StreamEncoder(dict_size, lc=lc, lp=lp, pb=pb, effort=effort)


def lzma2_compress_file(src_path: str, dst_path: str, *, level: int = 5,
                        dict_size: int | None = None,
                        effort: int | None = None,
                        read_size: int = 1 << 20,
                        progress=None) -> int:
    """File-to-file LZMA2 encode in O(dict) memory; returns the dict prop.

    The output is the raw LZMA2 stream; only the sliding window and one
    read buffer are resident.  ``progress(done_bytes, out_bytes)`` after
    each read; False aborts with ProgressAborted."""
    enc = lzma2_compress_stream(level=level, dict_size=dict_size,
                                effort=effort)
    done = 0
    with open(src_path, "rb") as fin, open(dst_path, "wb") as fout:
        while True:
            piece = fin.read(read_size)
            if not piece:
                break
            fout.write(enc.compress(piece))
            done += len(piece)
            if progress is not None and progress(done, fout.tell()) is False:
                raise ProgressAborted()
        fout.write(enc.flush())
    return enc.dict_prop


def default_dict_size(level: int) -> int:
    """Level -> dictSize table of the reference (``LzmaLib.h:44-52``)."""
    table = {0: 1 << 14, 1: 1 << 16, 2: 1 << 18, 3: 1 << 20,
             4: 1 << 22, 5: 1 << 24, 6: 1 << 25}
    return table.get(level, 1 << 26)


def default_effort(level: int) -> int:
    """Level -> parse, as ``LzmaEncProps_Normalize`` (``LzmaEnc.c:53-74``):
    level < 5 the fast lazy parse, level >= 5 BT4 + optimal parse, level >=
    9 a deeper BT walk."""
    if level >= 9:
        return 11
    return 10 if level >= 5 else 9


def lzma2_uncompress(stream: bytes, dict_prop: int, *, engine="device",
                     device="cuda", threads: int | None = None,
                     progress=None) -> bytes:
    """Decompress a raw LZMA2 stream.

    ``engine``: ``"device"`` (the default) decodes the dict-reset groups
    with K1 on ``device``; ``"hybrid"`` runs host threads and K1 on one
    group queue (``parallel/hybrid.py``); ``"host"`` decodes on ``threads``
    host threads (``parallel/host_pool.decode_lzma2_mt``).  ``device="cuda"``
    (the default) launches the CUDA kernel and raises when there is no card;
    ``device="cpu"`` runs the kernel's plain PyTorch version.  ``threads``
    is the host engines' thread count (None: every core).

    ``progress(in_bytes, out_bytes)`` is called as groups complete; returning
    False aborts with ``ProgressAborted``.  The hybrid and host engines report
    per group.  The device engine has no per-group hook, so a ``progress``
    callback there sends the call to the host engine instead, as the JAX
    package does (abort semantics preserved).

    Each group's (lc, lp, pb) comes from the stream: the scheduler launches
    each props in its own batch.  The device engine makes the result once,
    at the size the chunk headers give, and writes every group into it at
    its offset (``BatchedLzma2Decoder.decode_into``).  Each call is one root
    span, ``api.lzma2_uncompress`` (``utils/trace.py``).
    """
    with TRACE.span("api.lzma2_uncompress", call=True):
        return _uncompress(stream, dict_prop, engine, device, threads,
                           progress)


def _uncompress(stream, dict_prop, engine, device, threads, progress):
    from .models.lzma2 import framing

    if engine not in ENGINES:
        raise UnsupportedError(f"unknown engine {engine!r}; one of {ENGINES}")
    if engine == "host" or (engine == "device" and progress is not None):
        from .parallel.host_pool import decode_lzma2_mt
        return decode_lzma2_mt(stream, dict_prop, threads=threads,
                               progress=progress)
    if engine == "hybrid":
        from .parallel.hybrid import decode_lzma2_hybrid
        return decode_lzma2_hybrid(stream, dict_prop, threads=threads,
                                   device=device, progress=progress)
    from .parallel.scheduler import BatchedLzma2Decoder
    from .utils.memory import result_bytes, shape_for_groups

    device = check_device(device)
    framing.decode_dict_prop(dict_prop)  # validate
    with TRACE.span("framing.scan"):
        chunks = framing.scan(stream)[0]
    with TRACE.span("framing.split_groups"):
        groups = framing.split_groups(chunks)
    dec = BatchedLzma2Decoder(shape_for_groups(groups, device=device),
                              device=device)
    out, view = result_bytes(sum(c.unpack_size for c in chunks))
    dec.decode_into(stream, groups, view)
    with TRACE.span("api.join"):
        del view    # every group is in place: the result is whole
    return out
