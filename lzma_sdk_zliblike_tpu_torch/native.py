"""ctypes bindings to the port's own copy of the native C++ runtime.

The counterpart of the JAX package's ``native.py``, for the calls the port
needs: ``lzt_lzma2_group_ops`` (the fast parse of one dict-reset group,
exporting op records for the range-encode kernel), ``lzt_lzma2_encode`` and
``lzt_lzma2_decode`` (the host LZMA2 encoder and decoder),
``lzt_lzma2_encode_ext`` (the host encoder drawing its match candidates from
the device match finder X2), ``lzt_lzma_encode`` and ``lzt_lzma_decode``
(raw LZMA, one stream), ``lzt_stream_enc_*`` (the bounded-memory streaming
LZMA2 encoder, ``Lzma2StreamEncoder``), ``lzt_stream_dec_*`` and
``lzt_stream2_dec_*`` (the resumable raw-LZMA and LZMA2 decoders,
``LzmaStreamDecoder`` / ``Lzma2StreamDecoder``), ``lzt_ppmd7_decode`` /
``lzt_ppmd7_encode`` (PPMd var.H, 7z method 0x030401) and ``lzt_crc64``
(the xz container's CRC64).
The sources are ``csrc/host/lzt_codec.cc`` and ``csrc/host/lzt_ppmd7.cc``,
copies of the JAX package's ``native/`` files.  At first use they are built
with g++ into one ``build/torch_host/liblzt_host_<hash>.so`` (the hash
covers both sources and the flags, so an edited source is rebuilt), written
under a temporary name and renamed, so that concurrent test workers never
load a half-written library.  There is no fallback: a missing g++ or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from .models.lzma.spec import LzmaProps
from .utils.errors import DataError, ParamError, raise_for_sres

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "host", "lzt_codec.cc")
PPMD_SOURCE = os.path.join(_PKG, "csrc", "host", "lzt_ppmd7.cc")
SOURCES = (SOURCE, PPMD_SOURCE)
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_host")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"liblzt_host_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host runtime "
                           "(csrc/host/*.cc) cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    r = subprocess.run([gxx, *CXX_FLAGS, "-o", tmp, *SOURCES],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCES} (exit "
                           f"{r.returncode}):\n{r.stderr[-4000:]}")
    os.replace(tmp, path)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            _bind(lib)
            _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.lzt_lzma2_encode.restype = ctypes.c_int
    lib.lzt_lzma2_encode.argtypes = [
        u8p, ctypes.c_size_t,
        u8p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,   # dict, chunk, parallel
        ctypes.c_int, ctypes.c_int, ctypes.c_int,         # lc lp pb
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),       # effort, prop_out
    ]
    lib.lzt_lzma2_encode_ext.restype = ctypes.c_int
    lib.lzt_lzma2_encode_ext.argtypes = (
        lib.lzt_lzma2_encode.argtypes
        + [ctypes.POINTER(ctypes.c_int32), ctypes.c_int])  # ext, K
    lib.lzt_lzma2_decode.restype = ctypes.c_int
    lib.lzt_lzma2_decode.argtypes = [
        u8p, ctypes.c_size_t,
        u8p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int,                                     # dict prop
    ]
    lib.lzt_lzma_decode.restype = ctypes.c_int
    lib.lzt_lzma_decode.argtypes = [
        u8p, ctypes.c_size_t,
        u8p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,  # lc lp pb dict
        ctypes.c_int,                                     # has_size
    ]
    lib.lzt_lzma_encode.restype = ctypes.c_int
    lib.lzt_lzma_encode.argtypes = [
        u8p, ctypes.c_size_t,
        u8p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,  # lc lp pb dict
        ctypes.c_int, ctypes.c_int,                       # end mark, effort
    ]
    lib.lzt_stream_enc_new.restype = ctypes.c_void_p
    lib.lzt_stream_enc_new.argtypes = [
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.lzt_stream_enc_feed.restype = None
    lib.lzt_stream_enc_feed.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.lzt_stream_enc_finish.restype = None
    lib.lzt_stream_enc_finish.argtypes = [ctypes.c_void_p]
    lib.lzt_stream_enc_drain.restype = ctypes.c_size_t
    lib.lzt_stream_enc_drain.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.lzt_stream_enc_free.restype = None
    lib.lzt_stream_enc_free.argtypes = [ctypes.c_void_p]
    lib.lzt_stream_dec_new.restype = ctypes.c_void_p
    lib.lzt_stream_dec_new.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_longlong]                                # lc lp pb dict size
    lib.lzt_stream2_dec_new.restype = ctypes.c_void_p
    lib.lzt_stream2_dec_new.argtypes = [ctypes.c_uint32]
    for pre in ("lzt_stream_dec", "lzt_stream2_dec"):
        for name, res, args in (
                ("_feed", ctypes.c_longlong,
                 [ctypes.c_void_p, u8p, ctypes.c_size_t, ctypes.c_int]),
                ("_status", ctypes.c_int, [ctypes.c_void_p]),
                ("_pending", ctypes.c_size_t, [ctypes.c_void_p]),
                ("_total_out", ctypes.c_uint64, [ctypes.c_void_p]),
                ("_read", ctypes.c_size_t,
                 [ctypes.c_void_p, u8p, ctypes.c_size_t]),
                ("_free", None, [ctypes.c_void_p])):
            fn = getattr(lib, pre + name)
            fn.restype, fn.argtypes = res, args
    lib.lzt_ppmd7_decode.restype = ctypes.c_int
    lib.lzt_ppmd7_decode.argtypes = [
        u8p, ctypes.c_size_t, u8p,                        # src, props (5 B)
        u8p, ctypes.c_size_t]                             # dst, out size
    lib.lzt_ppmd7_encode.restype = ctypes.c_int
    lib.lzt_ppmd7_encode.argtypes = [
        u8p, ctypes.c_size_t, ctypes.c_int, ctypes.c_uint32,  # order, mem
        u8p, ctypes.POINTER(ctypes.c_size_t)]             # out, inout len
    lib.lzt_crc64.restype = ctypes.c_uint64
    lib.lzt_crc64.argtypes = [u8p, ctypes.c_size_t, ctypes.c_uint64]
    lib.lzt_lzma2_group_ops.restype = ctypes.c_int
    lib.lzt_lzma2_group_ops.argtypes = [
        u8p, ctypes.c_size_t, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int),
        u8p, ctypes.POINTER(ctypes.c_size_t)]


def _as_u8p(b: bytes):
    return ctypes.cast(ctypes.c_char_p(bytes(b)), ctypes.POINTER(ctypes.c_uint8))


def lzma_decode(src: bytes, props: LzmaProps, unpack_size: int | None) -> bytes:
    """Decode one raw LZMA stream with ``props``.  ``unpack_size`` None means
    the stream ends with an end marker; otherwise the output must reach it
    (DataError if not)."""
    lib = _load()
    # a bounded first buffer even when the declared size is huge: a corrupt
    # header must give DataError, not a giant allocation
    want = unpack_size
    cap = min(want if want is not None else max(1 << 16, len(src) * 64),
              max(1 << 26, len(src) * 64))
    while True:
        try:
            dst = ctypes.create_string_buffer(max(cap, 1))
        except MemoryError:
            raise_for_sres(2)  # SZ_ERROR_MEM
        n = ctypes.c_size_t(cap)
        r = lib.lzt_lzma_decode(
            _as_u8p(src), len(src),
            ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)), ctypes.byref(n),
            props.lc, props.lp, props.pb, props.dict_size,
            1 if (want is not None and want <= cap) else 0)
        if r == 7 and (want is None or cap < want):
            cap *= 4
            continue
        raise_for_sres(r)
        out = dst.raw[:n.value]
        if want is not None and len(out) != want:
            raise DataError("declared uncompressed size not reached")
        return out


def lzma_encode(data: bytes, props: LzmaProps, write_end_mark: bool = False,
                effort: int = 9) -> bytes:
    """One raw LZMA stream of ``data`` with ``props`` (no header);
    ``effort`` 1-9 is the lazy parse's depth, 10 and up the optimal parse."""
    lib = _load()
    cap = len(data) + len(data) // 2 + 4096
    dst = ctypes.create_string_buffer(cap)
    n = ctypes.c_size_t(cap)
    r = lib.lzt_lzma_encode(
        _as_u8p(data), len(data),
        ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)), ctypes.byref(n),
        props.lc, props.lp, props.pb, props.dict_size,
        1 if write_end_mark else 0, effort)
    raise_for_sres(r)
    return dst.raw[:n.value]


class Lzma2StreamEncoder:
    """Incremental LZMA2 encoder in O(dict) memory (a native sliding window).

    The compressobj-style counterpart of the reference's streaming encode
    (``LzmaEnc_Encode2``'s block loop over a MoveBlock window,
    ``LzmaEnc.c:2154-2184`` + ``LzFind.c:57-121``): ``compress()`` takes
    pieces of any size and returns what is ready, ``flush()`` the rest and
    the end byte.  The stream does not depend on how the input is cut.
    """

    def __init__(self, dict_size: int = 1 << 24, *, lc: int = 3,
                 lp: int = 0, pb: int = 2, effort: int = 9):
        self._lib = _load()
        prop = ctypes.c_int(0)
        self._h = self._lib.lzt_stream_enc_new(dict_size, lc, lp, pb, effort,
                                               ctypes.byref(prop))
        if not self._h:
            raise ParamError(f"bad stream encoder params lc/lp/pb "
                             f"{lc}/{lp}/{pb}")
        self.dict_prop = prop.value
        self._buf = (ctypes.c_uint8 * (1 << 20))()

    def _drain(self) -> bytes:
        out = bytearray()
        while True:
            n = self._lib.lzt_stream_enc_drain(self._h, self._buf,
                                               len(self._buf))
            if not n:
                return bytes(out)
            out += bytes(self._buf[:n])

    def compress(self, data) -> bytes:
        if self._h is None:
            raise ValueError("compress() after flush()")
        data = bytes(data)
        self._lib.lzt_stream_enc_feed(self._h, _as_u8p(data), len(data))
        return self._drain()

    def flush(self) -> bytes:
        if self._h is None:
            raise ValueError("flush() called twice")
        self._lib.lzt_stream_enc_finish(self._h)
        out = self._drain()
        self._lib.lzt_stream_enc_free(self._h)
        self._h = None
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lzt_stream_enc_free(self._h)
            self._h = None


def lzma2_encode(data: bytes, dict_size: int, chunk_size: int | None,
                 parallel: bool = True, lc: int = 3, lp: int = 0, pb: int = 2,
                 effort: int = 9) -> tuple[bytes, int]:
    """Raw LZMA2 stream of ``data``, ending with the end byte; returns
    (stream, prop).  ``parallel`` resets the dictionary every
    ``chunk_size`` bytes (dict-reset groups; None or 0 is the encoder's
    default); without it only the first chunk resets.  ``effort`` 1-9 is
    the lazy parse's depth, 10 the optimal parse."""
    lib = _load()
    cap = len(data) + len(data) // 2 + 4096 + 8 * (len(data) // 49152 + 2)
    dst = ctypes.create_string_buffer(cap)
    n = ctypes.c_size_t(cap)
    prop = ctypes.c_int(0)
    r = lib.lzt_lzma2_encode(
        _as_u8p(data), len(data),
        ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)), ctypes.byref(n),
        dict_size, chunk_size or 0, 1 if parallel else 0, lc, lp, pb, effort,
        ctypes.byref(prop))
    raise_for_sres(r)
    return dst.raw[:n.value], prop.value


def lzma2_encode_ext(data: bytes, ext, dict_size: int, chunk_size: int,
                     lc: int = 3, lp: int = 0, pb: int = 2,
                     effort: int = 9) -> tuple[bytes, int]:
    """``lzma2_encode`` in dict-reset groups, with the parse drawing its
    match candidates from ``ext``: int32 [len(data), K], the candidate
    distances of each position (0 = none), local to the position's group
    (X2, ``ops/match_find.py``, gives them so).  The parse measures each
    candidate again, so ``ext`` steers the size, never the bytes decoded.
    Returns (stream, prop)."""
    ext = np.ascontiguousarray(ext, np.int32)
    if ext.ndim != 2 or ext.shape[0] < len(data) or ext.shape[1] < 1:
        raise ParamError(f"ext must be [len(data) = {len(data)}, K], got "
                         f"{ext.shape}")
    lib = _load()
    cap = len(data) + len(data) // 2 + 4096 + 8 * (len(data) // 49152 + 2)
    dst = ctypes.create_string_buffer(cap)
    n = ctypes.c_size_t(cap)
    prop = ctypes.c_int(0)
    r = lib.lzt_lzma2_encode_ext(
        _as_u8p(data), len(data),
        ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)), ctypes.byref(n),
        dict_size, chunk_size, 1, lc, lp, pb, effort, ctypes.byref(prop),
        ext.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ext.shape[1])
    raise_for_sres(r)
    return dst.raw[:n.value], prop.value


def lzma2_decode(stream: bytes, prop: int,
                 size_hint: int | None = None) -> bytes:
    """Decode a raw LZMA2 stream (end byte included) on the host.
    ``size_hint`` is the expected output size; a buffer that proves too
    small is grown four times and the decode run again."""
    lib = _load()
    cap = size_hint if size_hint is not None else max(1 << 16, len(stream) * 8)
    src = _as_u8p(stream)
    while True:
        dst = ctypes.create_string_buffer(max(cap, 1))
        n = ctypes.c_size_t(cap)
        r = lib.lzt_lzma2_decode(
            src, len(stream), ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(n), prop)
        if r == 7:      # SZ_ERROR_OUTPUT_EOF: the output did not fit
            cap = max(cap * 4, 1 << 16)
            continue
        raise_for_sres(r)
        return dst.raw[:n.value]


def crc64(data, value: int = 0) -> int:
    """Rolling CRC64 (ECMA-182, xz's check) of ``data`` from ``value``."""
    data = bytes(data)
    return _load().lzt_crc64(_as_u8p(data), len(data), value)


def group_ops_cap(n: int) -> int:
    """The most op words the fast parse of a group of ``n`` bytes returns."""
    return 4 * n + 64


def lzma2_group_ops(data: bytes, dict_size: int, *, lc: int = 3, lp: int = 0,
                    pb: int = 2, sub_size: int = 48 << 10):
    """Fast-parse one dict-reset group, exporting the op stream.

    Returns ``(ops, chunk_tab, body)``: ops is a uint32 numpy array of
    2-word records (``csrc/lzma_enc_lane.cuh``), chunk_tab an [n_chunks, 3]
    int32 table of cumulative (op words, unpack bytes, body bytes), and body
    the concatenated native chunk bodies."""
    lib = _load()
    ops_cap = ctypes.c_size_t(group_ops_cap(len(data)))
    ops = np.zeros(ops_cap.value, np.uint32)
    max_chunks = len(data) // 1024 + 2
    tab = np.zeros(max_chunks * 3, np.int32)
    n_chunks = ctypes.c_int(max_chunks)
    body_cap = ctypes.c_size_t(len(data) + len(data) // 2 + 4096)
    body = ctypes.create_string_buffer(body_cap.value)
    r = lib.lzt_lzma2_group_ops(
        _as_u8p(data), len(data), dict_size, lc, lp, pb, sub_size,
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.byref(ops_cap),
        tab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(n_chunks),
        ctypes.cast(body, ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(body_cap))
    raise_for_sres(r)
    return (ops[:ops_cap.value].copy(),
            tab[:n_chunks.value * 3].reshape(-1, 3).copy(),
            body.raw[:body_cap.value])


class _StreamDecoder:
    """The wrapper shared by the native resumable decoders.

    ``feed`` is given the caller's whole unconsumed input each call and
    returns how much it consumed: the native side keeps no input.  Decoded
    bytes collect in the native dictionary window, drained with ``read``.
    """

    _PREFIX = ""

    def __init__(self, handle):
        self._lib = _load()
        self._h = handle
        self._rbuf = (ctypes.c_uint8 * (1 << 20))()

    def _call(self, name):
        return getattr(self._lib, self._PREFIX + name)

    def feed(self, data, finish: bool = False) -> int:
        """Consume a prefix of ``data`` and return its length; raise on a
        decode error.  Once the stream has ended, ``done`` is True and no
        byte is consumed again."""
        b = bytes(data)
        c = self._call("_feed")(self._h, _as_u8p(b), len(b),
                                1 if finish else 0)
        st = self._call("_status")(self._h)
        if st < 0:
            raise_for_sres(-st)
        return int(c)

    @property
    def done(self) -> bool:
        return self._call("_status")(self._h) == 1

    @property
    def total_out(self) -> int:
        return self._call("_total_out")(self._h)

    def pending(self) -> int:
        return self._call("_pending")(self._h)

    def read(self, max_length: int = -1) -> bytes:
        """Drain up to ``max_length`` decoded bytes (all that are pending
        if it is None or negative)."""
        out = bytearray()
        want = self.pending() if max_length is None or max_length < 0 \
            else max_length
        while want > 0:
            n = self._call("_read")(self._h, self._rbuf,
                                    min(want, len(self._rbuf)))
            if not n:
                break
            out += ctypes.string_at(self._rbuf, n)
            want -= n
        return bytes(out)

    def close(self) -> None:
        if self._h:
            self._call("_free")(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


class LzmaStreamDecoder(_StreamDecoder):
    """Resumable raw-LZMA decoder (the ``LzmaDec_DecodeToBuf`` role,
    ``LzmaDec.c:840-878``) in O(dict) memory.  ``unpack_size`` None means
    an end marker ends the stream."""

    _PREFIX = "lzt_stream_dec"

    def __init__(self, props: LzmaProps, unpack_size: int | None = None):
        h = _load().lzt_stream_dec_new(
            props.lc, props.lp, props.pb, props.dict_size,
            -1 if unpack_size is None else unpack_size)
        if not h:
            raise ParamError("bad LZMA props")
        super().__init__(h)


class Lzma2StreamDecoder(_StreamDecoder):
    """Resumable LZMA2 decoder (the chunk-header state machine and chunk
    decode of ``Lzma2Dec.c:47-157``) in O(dict) memory."""

    _PREFIX = "lzt_stream2_dec"

    def __init__(self, dict_size: int):
        super().__init__(_load().lzt_stream2_dec_new(dict_size))


def ppmd7_decode(src: bytes, props: bytes, out_size: int) -> bytes:
    """Decode ``out_size`` bytes of a PPMd7 stream (7z method 0x030401);
    byte-identical to ``models/ppmd7/codec.py``'s reference."""
    lib = _load()
    dst = ctypes.create_string_buffer(max(out_size, 1))
    r = lib.lzt_ppmd7_decode(_as_u8p(src), len(src), _as_u8p(props),
                             ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)),
                             out_size)
    if r == -4:
        raise ParamError("ppmd props")
    if r != 0:
        raise DataError(f"ppmd decode error {r}")
    return dst.raw[:out_size]


def ppmd7_encode(data: bytes, order: int, mem_size: int) -> bytes:
    """One PPMd7 stream of ``data`` at ``order`` and ``mem_size``."""
    lib = _load()
    cap = max(1024, len(data) + (len(data) >> 1) + 1024)
    while True:
        out = ctypes.create_string_buffer(cap)
        n = ctypes.c_size_t(cap)
        r = lib.lzt_ppmd7_encode(_as_u8p(data), len(data), order, mem_size,
                                 ctypes.cast(out,
                                             ctypes.POINTER(ctypes.c_uint8)),
                                 ctypes.byref(n))
        if r == -90:        # the output did not fit: n holds the size needed
            cap = n.value
            continue
        if r == -4:
            raise ParamError("ppmd params")
        if r != 0:
            raise DataError(f"ppmd encode error {r}")
        return out.raw[:n.value]
