"""Zlib-like streaming decompression objects — the fork's namesake surface.

The reference exposes a "zlib-like" buffer-to-buffer decode level
(``LzmaDec_DecodeToBuf``, ``LzmaDec.c:840-878``) on top of the resumable
dictionary decoder (``LzmaDec_DecodeToDic`` + 20-byte ``tempBuf`` boundary
handling, ``LzmaDec.c:719-838``).  Here the same capability takes the shape
Python users know from ``zlib.decompressobj``: feed arbitrary input
fragments, drain bounded output, bounded memory (dictionary-sized window).

Differences from ``zlib.decompressobj`` (documented, deliberate):

* unconsumed input is held internally — there is no ``unconsumed_tail``;
  call ``decompress(b"")`` or ``flush()`` to drain pending output.
* ``unused_data`` is populated with any bytes past the logical end of the
  stream once ``eof`` is True, as in zlib.

Instead of the reference's speculative ``LzmaDec_TryDummy``
(``LzmaDec.c:487-675``) — needed there because the C API may not hold input
back — these objects simply keep unconsumed input buffered and pause the
decoder at a symbol boundary whenever fewer than ``INPUT_MARGIN`` bytes
remain, so no speculation is ever required.  The margin is a safe multiple
of the reference's ``LZMA_REQUIRED_INPUT_MAX`` (= 20, ``LzmaDec.h:19``).

The port's copy of the JAX package's ``streams/zlike.py``.  Engines:
``"auto"`` / ``"native"`` the native resumable decoders
(``native.LzmaStreamDecoder`` / ``Lzma2StreamDecoder``, always built),
``"py"`` the scalar reference decoder below.  Any other name raises
UnsupportedError, where the JAX classes run the native decoder for it.
"""

from __future__ import annotations

from .. import native
from ..models.lzma import spec as S
from ..models.lzma.decoder_ref import LzmaDecoder, RangeDecoder
from ..models.lzma2 import framing
from ..utils.errors import DataError, InputEofError, UnsupportedError

# One LZMA symbol consumes at most LZMA_REQUIRED_INPUT_MAX (20) input
# bytes; pause only when below a comfortable multiple of that.
INPUT_MARGIN = 64

_TRIM_SLACK = 1 << 16  # amortize front-trims of the history buffer

ENGINES = ("auto", "native", "py")


def _native_engine(engine: str) -> bool:
    """True for the native decoder, False for ``"py"``; UnsupportedError
    for any other name (streams decode on the host only)."""
    if engine not in ENGINES:
        raise UnsupportedError(
            f"engine {engine!r}: streaming decode runs on the host only, "
            f"one of {ENGINES}")
    return engine != "py"


class LzmaDecodeStream:
    """Streaming raw-LZMA decoder (``LzmaDec_DecodeToBuf`` role).

    ``props``: an ``LzmaProps`` or the 5-byte out-of-band props blob.
    ``unpack_size``: expected output size, or None to decode until the
    end marker.
    """

    def __init__(self, props, unpack_size: int | None = None,
                 engine: str = "auto"):
        if isinstance(props, (bytes, bytearray)):
            props = S.LzmaProps.from_bytes(bytes(props))
        self._nd = None
        if _native_engine(engine):
            # the native resumable decoder (the role of the reference's
            # C-hot LzmaDec_DecodeToBuf, LzmaDec.c:840-878)
            self._nd = native.LzmaStreamDecoder(props, unpack_size)
        self._dec = LzmaDecoder(props) if self._nd is None else None
        self._rc: RangeDecoder | None = None
        self._in = bytearray()
        self._out = bytearray()
        self._emit_from = 0
        self._dic_start = 0          # may go negative after window trims
        self._unpack = unpack_size
        self._total_out = 0
        self.eof = False
        self.unused_data = b""

    def decompress(self, data: bytes = b"", max_length: int = -1) -> bytes:
        if self.eof:
            if data:
                self.unused_data += bytes(data)
            return self._drain(max_length)
        self._in += data
        if self._nd is not None:
            self._nfeed(finish=False)
        else:
            self._run(finish=False)
        return self._drain(max_length)

    def flush(self) -> bytes:
        if not self.eof:
            if self._nd is not None:
                self._nfeed(finish=True)
            else:
                self._run(finish=True)
            if not self.eof:
                raise InputEofError("LZMA stream truncated")
        return self._drain(-1)

    def _nfeed(self, finish: bool) -> None:
        consumed = self._nd.feed(self._in, finish=finish)
        del self._in[:consumed]
        if self._nd.done:
            self.eof = True
            self.unused_data += bytes(self._in)
            self._in.clear()

    # -- internals ---------------------------------------------------------
    def _run(self, finish: bool) -> None:
        if self._unpack == 0:
            self.eof = True
            self.unused_data += bytes(self._in)
            self._in.clear()
            return
        if self._rc is None:
            if len(self._in) < 5:
                if finish:
                    raise InputEofError("LZMA stream shorter than RC header")
                return
            self._rc = RangeDecoder(self._in, 0, len(self._in))
            self._rc.init()
            del self._in[:self._rc.pos]
            self._rc.pos = 0
        rc = self._rc
        rc.src = self._in
        rc.limit = len(self._in)
        remaining = (None if self._unpack is None
                     else self._unpack - self._total_out)
        before = len(self._out)
        _, mark = self._dec.decode(
            self._in, self._out, unpack_limit=remaining,
            dic_start=self._dic_start, rc=rc,
            input_margin=None if finish else INPUT_MARGIN)
        self._total_out += len(self._out) - before
        if rc.pos:
            del self._in[:rc.pos]
            rc.pos = 0
            rc.limit = len(self._in)
        if mark or (self._unpack is not None
                    and self._total_out >= self._unpack):
            self.eof = True
            self.unused_data += bytes(self._in)
            self._in.clear()

    def _drain(self, max_length: int) -> bytes:
        if self._nd is not None:
            return self._nd.read(max_length)
        end = (len(self._out) if max_length is None or max_length < 0
               else min(len(self._out), self._emit_from + max_length))
        r = bytes(self._out[self._emit_from:end])
        self._emit_from = end
        self._trim(self._dec.props.dict_size)
        return r

    def _trim(self, window: int) -> None:
        drop = min(self._emit_from, len(self._out) - window)
        if drop > _TRIM_SLACK:
            del self._out[:drop]
            self._emit_from -= drop
            self._dic_start -= drop


class Lzma2DecodeStream:
    """Streaming raw-LZMA2 decoder (chunk-grammar push parser).

    Mirrors the reference's byte-level LZMA2 header state machine
    (``Lzma2Dec.c:47-157``) at chunk granularity: headers are parsed as
    they arrive and each chunk's payload is decoded once complete
    (chunks are ≤ 64 KB packed by construction, so buffering one is the
    same bound the reference's dictionary interface has).
    """

    def __init__(self, dict_prop: int, engine: str = "auto"):
        self._F = framing
        self._dict_size = framing.decode_dict_prop(dict_prop)
        self._nd = None
        if _native_engine(engine):
            self._nd = native.Lzma2StreamDecoder(self._dict_size)
        self._dec: LzmaDecoder | None = None
        self._in = bytearray()
        self._out = bytearray()
        self._emit_from = 0
        self._dic_start = 0
        self._need_init_state = True
        self.eof = False
        self.unused_data = b""

    def decompress(self, data: bytes = b"", max_length: int = -1) -> bytes:
        if self.eof:
            if data:
                self.unused_data += bytes(data)
            return self._drain(max_length)
        self._in += data
        if self._nd is not None:
            self._nfeed(finish=False)
        else:
            self._run()
        return self._drain(max_length)

    def flush(self) -> bytes:
        if not self.eof:
            if self._nd is not None:
                self._nfeed(finish=True)
            else:
                self._run()
            if not self.eof:
                raise InputEofError("LZMA2 stream truncated (no EOS)")
        return self._drain(-1)

    def _nfeed(self, finish: bool) -> None:
        consumed = self._nd.feed(self._in, finish=finish)
        del self._in[:consumed]
        if self._nd.done:
            self.eof = True
            self.unused_data += bytes(self._in)
            self._in.clear()

    # -- internals ---------------------------------------------------------
    def _run(self) -> None:
        F = self._F
        while self._in and not self.eof:
            ctrl = self._in[0]
            if ctrl == F.CTRL_EOS:
                self.eof = True
                self.unused_data += bytes(self._in[1:])
                self._in.clear()
                return
            if ctrl in (F.CTRL_COPY_RESET_DIC, F.CTRL_COPY_NO_RESET):
                if len(self._in) < 3:
                    return
                size = ((self._in[1] << 8) | self._in[2]) + 1
                if len(self._in) < 3 + size:
                    return
                if ctrl == F.CTRL_COPY_RESET_DIC:
                    self._dic_start = len(self._out)
                self._out += self._in[3:3 + size]
                del self._in[:3 + size]
                self._need_init_state = True
                continue
            if ctrl < 0x80:
                raise DataError(f"bad LZMA2 control byte {ctrl:#x}")
            mode = (ctrl >> 5) & 3
            hdr = 5 + (1 if mode >= F.MODE_STATE_PROPS else 0)
            if len(self._in) < hdr:
                return
            unpack = (((ctrl & 0x1F) << 16) | (self._in[1] << 8)
                      | self._in[2]) + 1
            pack = ((self._in[3] << 8) | self._in[4]) + 1
            if len(self._in) < hdr + pack:
                return
            if mode == F.MODE_STATE_PROPS_DIC:
                self._dic_start = len(self._out)
            if mode >= F.MODE_STATE_PROPS:
                pb_lp_lc = self._in[5]
                props = S.LzmaProps.from_bytes(
                    bytes([pb_lp_lc])
                    + min(self._dict_size, 0xFFFFFFFF).to_bytes(4, "little"))
                if self._dec is None or self._dec.props != props:
                    self._dec = LzmaDecoder(props)
                else:
                    self._dec.reset_state()
                self._need_init_state = False
            elif mode == F.MODE_STATE:
                if self._dec is None:
                    raise DataError("LZMA2 state reset before props")
                self._dec.reset_state()
                self._need_init_state = False
            elif self._dec is None or self._need_init_state:
                raise DataError("LZMA2 chunk needs state reset after copy")
            expected = len(self._out) + unpack
            src_end, _ = self._dec.decode(
                self._in, self._out, unpack_limit=unpack,
                src_pos=hdr, src_limit=hdr + pack,
                dic_start=self._dic_start)
            if len(self._out) != expected:
                raise DataError("LZMA2 chunk produced wrong unpack size")
            if src_end != hdr + pack:
                raise DataError("LZMA2 chunk consumed wrong pack size")
            del self._in[:hdr + pack]

    def _drain(self, max_length: int) -> bytes:
        if self._nd is not None:
            return self._nd.read(max_length)
        end = (len(self._out) if max_length is None or max_length < 0
               else min(len(self._out), self._emit_from + max_length))
        r = bytes(self._out[self._emit_from:end])
        self._emit_from = end
        drop = min(self._emit_from, len(self._out) - self._dict_size)
        if drop > _TRIM_SLACK:
            del self._out[:drop]
            self._emit_from -= drop
            self._dic_start -= drop
        return r


class XzDecodeStream:
    """``decompressobj``-shaped wrapper over the .xz push parser
    (``XzStreamDecoder``, containers/xz.py)."""

    def __init__(self, *, verify: bool = True):
        from ..containers.xz import XzStreamDecoder
        self._pending: list[bytes] = []
        self._dec = XzStreamDecoder(sink=self._pending.append,
                                    verify=verify)
        self._tail = b""
        self.eof = False
        self.unused_data = b""

    def decompress(self, data: bytes = b"", max_length: int = -1) -> bytes:
        if not self.eof:
            self._dec.feed(data)
        elif data:
            self.unused_data += bytes(data)
        return self._drain(max_length)

    def flush(self) -> bytes:
        if not self.eof:
            self._dec.finish()
            self.eof = True
        return self._drain(-1)

    def _drain(self, max_length: int) -> bytes:
        buf = self._tail + b"".join(self._pending)
        self._pending.clear()
        if max_length is None or max_length < 0:
            self._tail = b""
            return buf
        self._tail = buf[max_length:]
        return buf[:max_length]


def decompressobj(format: str = "lzma", **kw):
    """Factory: ``format`` in {"lzma", "lzma2", "xz"}."""
    if format == "lzma":
        return LzmaDecodeStream(kw.pop("props"), **kw)
    if format == "lzma2":
        return Lzma2DecodeStream(kw.pop("dict_prop"), **kw)
    if format == "xz":
        return XzDecodeStream(**kw)
    raise ValueError(f"unknown streaming format {format!r}")
