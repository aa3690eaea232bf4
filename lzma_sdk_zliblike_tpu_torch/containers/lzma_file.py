""".lzma file format (13-byte header + raw LZMA stream).

Header layout (what ``LzmaUtil.c:134-166`` writes): 5 props bytes
(lc/lp/pb packed + LE32 dictSize) followed by LE64 uncompressed size, with
``0xFFFFFFFFFFFFFFFF`` meaning "unknown — stream ends with an end marker".
The port's copy of the JAX package's ``containers/lzma_file.py``, on the
host (``engine.py``: a device engine name raises UnsupportedError).
"""

from __future__ import annotations

from ..models.lzma.spec import LzmaProps, LZMA_PROPS_SIZE
from ..utils.errors import InputEofError

HEADER_SIZE = LZMA_PROPS_SIZE + 8
UNKNOWN_SIZE = 0xFFFFFFFFFFFFFFFF


def parse_header(data: bytes) -> tuple[LzmaProps, int | None]:
    if len(data) < HEADER_SIZE:
        raise InputEofError(".lzma header truncated")
    props = LzmaProps.from_bytes(data[:LZMA_PROPS_SIZE])
    size = int.from_bytes(data[LZMA_PROPS_SIZE:HEADER_SIZE], "little")
    return props, (None if size == UNKNOWN_SIZE else size)


def build_header(props: LzmaProps, unpack_size: int | None) -> bytes:
    size = UNKNOWN_SIZE if unpack_size is None else unpack_size
    return props.to_bytes() + size.to_bytes(8, "little")


def decode(data: bytes, *, engine: str = "auto") -> bytes:
    """Decode a whole .lzma file image to bytes."""
    props, size = parse_header(data)
    from ..engine import lzma_raw_decode
    return lzma_raw_decode(data[HEADER_SIZE:], props, size, engine=engine)


def encode(data: bytes, props: LzmaProps | None = None, *,
           write_end_mark: bool = False, engine: str = "auto") -> bytes:
    """Encode bytes to a whole .lzma file image."""
    from ..engine import lzma_raw_encode
    props = props or LzmaProps()
    body = lzma_raw_encode(data, props, write_end_mark=write_end_mark,
                           engine=engine)
    return build_header(props, None if write_end_mark else len(data)) + body
