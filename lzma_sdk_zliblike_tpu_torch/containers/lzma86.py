""".lzma86 format: BCJ-filtered LZMA with a tiny header.

Layout (``Lzma86.h:14-25``): 1 filter-mode byte (0 = none, 1 = x86 BCJ),
5 LZMA props bytes, LE64 uncompressed size, then the raw LZMA stream.
``SZ_FILTER_AUTO`` encodes both ways and keeps the smaller result (the
reference's up-to-3-pass scheme, ``Lzma86Enc.c:63-101``).  The port's copy
of the JAX package's ``containers/lzma86.py``, on the host (``engine.py``:
a device engine name raises UnsupportedError).
"""

from __future__ import annotations

from ..models.lzma.spec import LzmaProps, LZMA_PROPS_SIZE
from ..ops.filters import x86_convert
from ..utils.errors import DataError, InputEofError, ParamError

HEADER_SIZE = 1 + LZMA_PROPS_SIZE + 8

FILTER_NO = 0
FILTER_YES = 1
FILTER_AUTO = 2


def encode(data: bytes, *, level: int = 5, dict_size: int = 1 << 24,
           filter_mode: int = FILTER_AUTO, engine: str = "auto") -> bytes:
    from ..engine import lzma_raw_encode
    props = LzmaProps(dict_size=dict_size)

    candidates = []
    if filter_mode in (FILTER_NO, FILTER_AUTO):
        candidates.append((0, data))
    if filter_mode in (FILTER_YES, FILTER_AUTO):
        filtered, _state, _done = x86_convert(data, 0, True)
        candidates.append((1, filtered))
    if not candidates:
        raise ParamError(f"bad filter mode {filter_mode}")

    best = None
    for fid, payload in candidates:
        stream = lzma_raw_encode(payload, props, engine=engine)
        if best is None or len(stream) < len(best[1]):
            best = (fid, stream)
    fid, stream = best
    header = bytes([fid]) + props.to_bytes() + len(data).to_bytes(8, "little")
    return header + stream


def get_unpack_size(data: bytes) -> int:
    if len(data) < HEADER_SIZE:
        raise InputEofError(".lzma86 header truncated")
    return int.from_bytes(data[6:14], "little")


def decode(data: bytes, *, engine: str = "auto") -> bytes:
    from ..engine import lzma_raw_decode
    if len(data) < HEADER_SIZE:
        raise InputEofError(".lzma86 header truncated")
    fid = data[0]
    if fid > 1:
        raise DataError(f"bad .lzma86 filter id {fid}")
    props = LzmaProps.from_bytes(data[1:6])
    size = int.from_bytes(data[6:14], "little")
    out = lzma_raw_decode(data[HEADER_SIZE:], props, size, engine=engine)
    if fid == 1:
        out, _state, _done = x86_convert(out, 0, False)
    return out
