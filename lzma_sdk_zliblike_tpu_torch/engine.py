"""Engine dispatch for raw LZMA: one stream, on the host.

The counterpart of the JAX package's ``engine.py`` (``lzma_raw_decode`` /
``lzma_raw_encode``).  A raw LZMA stream is one serial stream with no
dict-reset groups, so it has no device route in either package.  Engines:

* ``native`` -- the port's C++ codec (``native.py``), always built;
* ``python`` -- the pure-Python reference codec
  (``models/lzma/decoder_ref.py``, ``encoder_ref.py``);
* ``auto`` -- native (there is no silent Python fallback).

Any other name, a device engine's among them ("tpu", "device", "hybrid"),
raises UnsupportedError: the JAX package runs the Python codec for a device
engine name without saying so, the port refuses it.  The other host-only
paths that take an engine name (``framing.decode`` and ``encode``, PPMd7,
7z's ``write`` and ``decode_folder``) check it here too.  7z's
``extract`` and ``test`` take ``"device"`` before this check: their LZMA2
folders then decode on K1 (``containers/sevenzip._extract_device``), and
the archive's LZMA-coded header and its other folders on the host.
"""

from __future__ import annotations

from .models.lzma.spec import LzmaProps
from .utils.errors import UnsupportedError

ENGINES = ("auto", "native", "python")


def check_engine(engine: str, what: str = "raw LZMA") -> str:
    """``engine`` if ``what`` runs on it; UnsupportedError otherwise."""
    if engine not in ENGINES:
        raise UnsupportedError(
            f"engine {engine!r}: {what} runs on the host only, one of "
            f"{ENGINES} (no device route in either package)")
    return engine


def lzma_raw_decode(src: bytes, props: LzmaProps, unpack_size: int | None,
                    *, engine: str = "auto") -> bytes:
    """Decode one raw LZMA stream; ``unpack_size`` None means an end marker
    ends it."""
    if check_engine(engine) == "python":
        from .models.lzma.decoder_ref import lzma_decode
        return lzma_decode(src, props, unpack_size)
    from . import native
    return native.lzma_decode(src, props, unpack_size)


def lzma_raw_encode(data: bytes, props: LzmaProps, *,
                    write_end_mark: bool = False, effort: int = 9,
                    engine: str = "auto") -> bytes:
    """One raw LZMA stream of ``data``.  The python engine has one parse
    (its own lazy one) and ignores ``effort``, as the JAX package's does."""
    if check_engine(engine) == "python":
        from .models.lzma.encoder_ref import lzma_encode
        return lzma_encode(data, props, write_end_mark=write_end_mark)
    from . import native
    return native.lzma_encode(data, props, write_end_mark, effort)
