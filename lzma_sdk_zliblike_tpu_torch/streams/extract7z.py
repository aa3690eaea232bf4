"""Constant-memory streaming .7z extraction (the fork's flagship feature).

Decodes each solid folder incrementally — bounded by the LZMA dictionary
window plus IO buffers — writing bytes straight into the destination files
(never holding a whole folder in RAM), with the temp-file spill + second
filter pass the fork uses when a branch filter sits on top of the codec:

* no filter:  codec → FileRouter
  (``SzDecodeLzma(2)ToFileWithBuf``, ``7zDec.c:567-766``)
* BCJ/branch: codec → temp file, then a carry-state streaming filter pass
  (``ApplyBCJ`` with the 4-byte retain buffer, ``7zDec.c:789-837``)
* BCJ2:       main codec → temp file; call/jump/rc small streams in RAM;
  resumable 4-stream merge (``ApplyBCJ2``/``Bcj2_DecodeToFileWithBufs``,
  ``7zDec.c:840-879``, ``Bcj2.c:129-229``)

Archive metadata is accessed through ``mmap`` (OS-paged, not loaded).

The port's copy of the JAX package's ``streams/extract7z.py``.  LZMA and
LZMA2 coders always run in the native resumable decoders
(``native.LzmaStreamDecoder`` / ``Lzma2StreamDecoder``), which hold the
dictionary window: the port's runtime is always built, so the JAX module's
pure-Python fallbacks (a ``WindowBuffer`` and the scalar decoder) are not
carried over.  The files extracted are byte-identical to the JAX
module's.
"""

from __future__ import annotations

import mmap
import os
import tempfile

from .. import native
from ..containers import sevenzip as SZ
from ..models.lzma.spec import LzmaProps
from ..models.lzma2 import framing
from ..ops import filters as FLT
from ..utils.checksums import crc32
from ..utils.errors import (CrcError, DataError, ProgressAborted,
                            UnsupportedError)
from .router import FileRouter

IN_BUF = 512 << 10   # the fork's 512 KB input hop
OUT_BUF = 1 << 20    # 1 MB output hop


def _folder_entries(ar: SZ.Archive, fi: int):
    rows = [(f.offset_in_folder, f.name, f.size, f.crc)
            for f in ar.files if f.has_stream and f.folder == fi]
    rows.sort()
    return [(name, size, crc) for _off, name, size, crc in rows]


def extract_streaming(path: str, out_dir: str, *, verify: bool = True,
                      temp_dir: str | None = None,
                      progress=None) -> list[str]:
    """Extract every file of a .7z archive with bounded memory.

    ``progress(in_bytes, out_bytes)`` is called at every routed output
    write with cumulative totals (``ICompressProgress``,
    ``Types.h:220-225``; in_bytes = packed bytes of fully processed
    folders); returning ``False`` aborts the extraction mid-folder with
    ``ProgressAborted`` — partially written member files are left on
    disk, as the reference's aborted ``SzArEx_Extract`` leaves its
    output buffer.

    Returns the list of extracted file names (including empty files/dirs).
    """
    names: list[str] = []
    with open(path, "rb") as fh:
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            ar = SZ.parse(mm)
            tally = {"in": 0, "out": 0}
            for fi in range(len(ar.folders)):
                ents = _folder_entries(ar, fi)
                if not ents:
                    continue
                router = FileRouter(ents, out_dir, verify=verify)
                if progress is not None:
                    inner_write = router.write

                    def write(data, _w=inner_write):
                        _w(data)
                        tally["out"] += len(data)
                        if progress(tally["in"], tally["out"]) is False:
                            raise ProgressAborted()
                    router.write = write
                _decode_folder_streaming(mm, ar, fi, router, verify,
                                         temp_dir)
                router.close()
                tally["in"] += sum(s for _o, s in _pack_slices(ar, fi))
                names += [e[0] for e in ents]
            # file times from the archive's MTime vector (the reference
            # sets them on extract, 7zMain.c:438-475)
            for f in ar.files:
                if f.has_stream and not f.is_dir:
                    SZ.apply_mtime(os.path.join(out_dir, f.name), f.mtime)
            # zero-size files and directories (ExtractZeroSizeFiles,
            # 7zIn.c:1428-1446)
            for f in ar.files:
                target = os.path.join(out_dir, f.name)
                if f.is_dir:
                    os.makedirs(target, exist_ok=True)
                    names.append(f.name)
                elif not f.has_stream:
                    os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
                    open(target, "wb").close()
                    SZ.apply_mtime(target, f.mtime)
                    names.append(f.name)
        finally:
            mm.close()
    return names


# ---------------------------------------------------------------------------

def _pack_slices(ar: SZ.Archive, fi: int):
    folder = ar.folders[fi]
    base_idx = ar.folder_pack_base[fi]
    off = ar.folder_pack_offset(fi)
    slices = []
    for k in range(len(folder.packed_indices)):
        size = ar.pack_sizes[base_idx + k]
        slices.append((off, size))
        off += size
    return slices


class _SinkCRC:
    """Tee sink adding a rolling folder CRC."""

    def __init__(self, fn):
        self.fn = fn
        self.crc = 0
        self.n = 0

    def __call__(self, data: bytes):
        self.crc = crc32(data, self.crc)
        self.n += len(data)
        self.fn(data)


def _decode_codec_streaming(mm, coder: SZ.Coder, pack_off: int,
                            pack_size: int, out_size: int, sink) -> None:
    """Stream one single-in/out codec's output into ``sink``."""
    m = coder.method
    if m == SZ.M_COPY:
        pos = pack_off
        left = out_size
        while left > 0:
            take = min(left, IN_BUF)
            sink(bytes(mm[pos:pos + take]))
            pos += take
            left -= take
        return
    if m == SZ.M_LZMA:
        nd = native.LzmaStreamDecoder(LzmaProps.from_bytes(coder.props),
                                      out_size)
    elif m == SZ.M_LZMA2:
        if len(coder.props) != 1:
            raise DataError("bad LZMA2 props")
        nd = native.Lzma2StreamDecoder(
            framing.decode_dict_prop(coder.props[0]))
    else:
        raise UnsupportedError(f"streaming codec {m:#x}")
    try:
        _native_stream_decode(mm, nd, pack_off, pack_size, sink)
        if nd.total_out != out_size:
            raise DataError("streamed folder size mismatch")
    finally:
        nd.close()


def _native_stream_decode(mm, nd, pack_off: int, pack_size: int,
                          sink) -> None:
    """Pump a native resumable decoder in IN_BUF input / OUT_BUF output
    hops — the role of the fork's 512KB/1MB double-buffer loop
    (``SzDecodeLzma(2)ToFileWithBuf``, ``7zDec.c:567-766``)."""
    buf = bytearray()
    pos = pack_off
    end = pack_off + pack_size
    while True:
        if pos < end and len(buf) < IN_BUF:
            take = min(end - pos, IN_BUF)
            buf += mm[pos:pos + take]
            pos += take
        finish = pos >= end
        consumed = nd.feed(buf, finish=finish)
        del buf[:consumed]
        out = nd.read(OUT_BUF)
        while out:
            sink(out)
            out = nd.read(OUT_BUF)
        if nd.done:
            return
        if finish and not consumed:
            raise DataError("native streaming decode stalled")


class StreamingBranchFilter:
    """Carry-state streaming wrapper for branch filters.

    Retains the unprocessable tail of each hop (x86: scan tail + 3-bit
    mask; aligned filters: alignment remainder) and prepends it to the next
    hop — the fork's ``BCJ_state`` idea (``7zDec.c:506-527``)."""

    _ALIGN = {SZ.M_ARM: 4, SZ.M_ARMT: 2, SZ.M_PPC: 4, SZ.M_SPARC: 4,
              SZ.M_IA64: 16}

    def __init__(self, method: int, props: bytes, sink):
        self.method = method
        self.sink = sink
        self.carry = b""
        self.ip = 0
        self.x86_state = 0
        self.delta_state = b""
        self.delta_dist = (props[0] + 1) if (method == SZ.M_DELTA and props) else 1

    def write(self, data: bytes) -> None:
        buf = self.carry + data
        m = self.method
        if m == SZ.M_BCJ:
            out, self.x86_state, done = FLT.x86_convert(buf, self.ip, False,
                                                        self.x86_state)
            self.sink(out[:done])
            self.carry = bytes(buf[done:])
            self.ip += done
        elif m == SZ.M_DELTA:
            out, self.delta_state = FLT.delta_decode(buf, self.delta_dist,
                                                     self.delta_state)
            self.sink(out)
            self.carry = b""
        else:
            align = self._ALIGN[m]
            done = (len(buf) // align) * align
            if done:
                out = SZ._BRANCH[m](buf[:done], self.ip, False)
                self.sink(out)
                self.ip += done
            self.carry = bytes(buf[done:])

    def close(self) -> None:
        if self.carry:
            self.sink(self.carry)
            self.carry = b""


def _decode_folder_streaming(mm, ar: SZ.Archive, fi: int, router: FileRouter,
                             verify: bool, temp_dir: str | None) -> None:
    folder = ar.folders[fi]
    slices = _pack_slices(ar, fi)
    coders = folder.coders
    crc_sink = _SinkCRC(router.write)

    def check_folder_crc():
        if verify and folder.crc is not None and crc_sink.crc != folder.crc:
            raise CrcError(f"folder {fi} CRC mismatch (streaming)")

    if len(coders) == 1:
        off, size = slices[0]
        _decode_codec_streaming(mm, coders[0], off, size,
                                folder.unpack_size, crc_sink)
        check_folder_crc()
        return

    # identify shape: main codec + single filter, or BCJ2
    fids = [c.method for c in coders]
    if len(coders) == 2 and (fids[1] in StreamingBranchFilter._ALIGN
                             or fids[1] in (SZ.M_BCJ, SZ.M_DELTA)):
        codec, filt = coders[0], coders[1]
        off, size = slices[0]
        with tempfile.NamedTemporaryFile(dir=temp_dir, prefix="lzt7z_",
                                         delete=False) as tf:
            tmp_path = tf.name
            # pass 1: decode codec output to temp (WriteTempStream)
            _decode_codec_streaming(
                mm, codec, off, size, folder.unpack_sizes[0],
                lambda b: tf.write(b))
        try:
            # pass 2: stream the filter over the temp file (ReadTempStream)
            sf = StreamingBranchFilter(filt.method, filt.props, crc_sink)
            with open(tmp_path, "rb") as rf:
                while True:
                    chunk = rf.read(IN_BUF)
                    if not chunk:
                        break
                    sf.write(chunk)
            sf.close()
        finally:
            os.unlink(tmp_path)
        check_folder_crc()
        return

    if SZ.M_BCJ2 in fids:
        _decode_bcj2_folder_streaming(mm, ar, fi, crc_sink, temp_dir)
        check_folder_crc()
        return

    raise UnsupportedError("unsupported folder shape for streaming")


def _decode_bcj2_folder_streaming(mm, ar: SZ.Archive, fi: int, sink,
                                  temp_dir: str | None) -> None:
    """BCJ2 folder: main codec → temp file; small streams in RAM; then a
    buffered 4-stream merge."""
    folder = ar.folders[fi]
    bi = next(i for i, c in enumerate(folder.coders)
              if c.method == SZ.M_BCJ2)
    bcj2 = folder.coders[bi]
    in_base = SZ._coder_in_index(folder, bi)
    ins_sources = []
    slices = _pack_slices(ar, fi)
    for j in range(bcj2.num_in):
        gin = in_base + j
        bp = folder.find_bind_pair_for_in(gin)
        if bp >= 0:
            out_idx = folder.bind_pairs[bp][1]
            ci = 0
            while SZ._coder_out_index(folder, ci) + folder.coders[ci].num_out <= out_idx:
                ci += 1
            cin = SZ._coder_in_index(folder, ci)
            cbp = folder.find_bind_pair_for_in(cin)
            if cbp >= 0:
                raise UnsupportedError("nested BCJ2 producer graph")
            k = folder.packed_indices.index(cin)
            ins_sources.append(("coder", ci, k, folder.unpack_sizes[out_idx]))
        else:
            k = folder.packed_indices.index(gin)
            ins_sources.append(("packed", None, k, ar.pack_sizes[
                ar.folder_pack_base[fi] + k]))

    out_size = folder.unpack_sizes[SZ._coder_out_index(folder, bi)]
    tmp_path = None
    small: list[bytes | None] = [None] * 4
    try:
        for j, (kind, ci, k, size) in enumerate(ins_sources):
            off, psize = slices[k]
            if kind == "packed" and j == 0:
                # main stream stored raw: spill it to temp unchanged
                with tempfile.NamedTemporaryFile(dir=temp_dir,
                                                 prefix="lzt7z_",
                                                 delete=False) as tf:
                    tmp_path = tf.name
                    pos = off
                    left = psize
                    while left > 0:
                        take = min(left, IN_BUF)
                        tf.write(mm[pos:pos + take])
                        pos += take
                        left -= take
            elif kind == "packed":
                small[j] = bytes(mm[off:off + psize])
            elif j == 0:
                with tempfile.NamedTemporaryFile(dir=temp_dir,
                                                 prefix="lzt7z_",
                                                 delete=False) as tf:
                    tmp_path = tf.name
                    _decode_codec_streaming(mm, folder.coders[ci], off,
                                            psize, size,
                                            lambda b: tf.write(b))
            else:
                buf = bytearray()
                _decode_codec_streaming(mm, folder.coders[ci], off, psize,
                                        size, buf.extend)
                small[j] = bytes(buf)
        with open(tmp_path, "rb") as rf:
            _bcj2_stream_merge(rf, small[1], small[2], small[3], out_size,
                               sink)
    finally:
        if tmp_path:
            os.unlink(tmp_path)


def _bcj2_stream_merge(main_reader, call: bytes, jump: bytes, rc: bytes,
                       out_size: int, sink) -> None:
    """Resumable BCJ2 merge reading `main` in bounded hops."""
    probs = [1024] * (2 + 256)
    if len(rc) < 5:
        raise DataError("bcj2 rc too short")
    code = int.from_bytes(rc[1:5], "big")
    rng = 0xFFFFFFFF
    rc_pos = 5
    MASK = 0xFFFFFFFF

    def decode_bit(i: int) -> int:
        nonlocal code, rng, rc_pos
        if rng < (1 << 24):
            rng = (rng << 8) & MASK
            b = rc[rc_pos] if rc_pos < len(rc) else 0
            code = ((code << 8) | b) & MASK
            rc_pos += 1
        p = probs[i]
        bound = (rng >> 11) * p
        if code < bound:
            rng = bound
            probs[i] = p + ((2048 - p) >> 5)
            return 0
        rng -= bound
        code -= bound
        probs[i] = p - (p >> 5)
        return 1

    c_pos = j_pos = 0
    prev = 0
    out_pos = 0
    pending = bytearray()

    def emit(bs: bytes):
        nonlocal out_pos
        pending.extend(bs)
        out_pos += len(bs)
        if len(pending) >= OUT_BUF:
            sink(bytes(pending))
            pending.clear()

    buf = b""
    bpos = 0
    while out_pos < out_size:
        if bpos >= len(buf):
            buf = main_reader.read(IN_BUF)
            bpos = 0
            if not buf:
                raise DataError("bcj2 main stream exhausted (streaming)")
        b = buf[bpos]
        bpos += 1
        emit(bytes([b]))
        if out_pos == out_size:
            break
        if (b & 0xFE) == 0xE8 or (prev == 0x0F and (b & 0xF0) == 0x80):
            pidx = (2 + prev) if b == 0xE8 else (0 if b == 0xE9 else 1)
            if decode_bit(pidx):
                src = call if b == 0xE8 else jump
                pos = c_pos if b == 0xE8 else j_pos
                if pos + 4 > len(src):
                    raise DataError("bcj2 target stream exhausted")
                dest = int.from_bytes(src[pos:pos + 4], "big")
                if b == 0xE8:
                    c_pos += 4
                else:
                    j_pos += 4
                rel = (dest - (out_pos + 4)) & MASK
                room = min(4, out_size - out_pos)
                emit(rel.to_bytes(4, "little")[:room])
                prev = (rel >> 24) & 0xFF
                continue
        prev = b
    sink(bytes(pending))
