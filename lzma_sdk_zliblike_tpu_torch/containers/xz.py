""".xz container: stream framing, block headers, index, integrity checks.

The port's copy of the JAX package's ``containers/xz.py`` (``encode``,
``decode``, ``read_backward`` and the streaming push decoder
``XzStreamDecoder``).
Parity targets in the reference: writer ``XzEnc.c`` (header ``:41-51``,
block header ``:53-77``, index+footer ``:79-122``), the block decode of
``XzDec.c:604-870`` with its filter chain (``XzDec.c:375-480``), and the
footer-first random-access reader ``XzIn.c:141-224``.

``decode`` sends each block's LZMA2 payload through the port's
``lzma2_uncompress``: on the card (``engine="device"``, K1 under the
budget-sized ``shape_for_groups``), host cores and the card together
(``"hybrid"``) or host threads alone (``"host"``).  ``encode`` runs on the
host, with the native encoder or, with ``threads``, the block-parallel one;
its image is byte-identical to the JAX package's at the same arguments.
Multi-block writing (``block_size=``) is supported, as there.
``XzStreamDecoder`` decodes each block's LZMA2 payload on the host with the
native resumable decoder (``native.Lzma2StreamDecoder``), which is always
built: the JAX class's pure-Python fallback is not carried over.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from .. import native
from ..api import lzma2_uncompress
from ..models.lzma2 import framing
from ..ops import filters as FLT
from ..utils.checksums import crc32, crc64, sha256
from ..utils.errors import (ArchiveError, CrcError, DataError, InputEofError,
                            UnsupportedError)

MAGIC = b"\xfd7zXZ\x00"
FOOTER_MAGIC = b"YZ"

CHECK_NONE = 0x00
CHECK_CRC32 = 0x01
CHECK_CRC64 = 0x04
CHECK_SHA256 = 0x0A
_CHECK_SIZES = {CHECK_NONE: 0, CHECK_CRC32: 4, CHECK_CRC64: 8, CHECK_SHA256: 32}
_CHECK_NAMES = {"none": CHECK_NONE, "crc32": CHECK_CRC32,
                "crc64": CHECK_CRC64, "sha256": CHECK_SHA256}

FILTER_DELTA = 0x03
FILTER_X86 = 0x04
FILTER_PPC = 0x05
FILTER_IA64 = 0x06
FILTER_ARM = 0x07
FILTER_ARMT = 0x08
FILTER_SPARC = 0x09
FILTER_LZMA2 = 0x21

_BRANCH_FILTERS = {
    FILTER_X86: None,  # handled specially (stateful mask)
    FILTER_PPC: FLT.ppc_convert,
    FILTER_IA64: FLT.ia64_convert,
    FILTER_ARM: FLT.arm_convert,
    FILTER_ARMT: FLT.armt_convert,
    FILTER_SPARC: FLT.sparc_convert,
}


def _write_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data, pos: int) -> tuple[int, int]:
    v = 0
    for i in range(9):
        if pos >= len(data):
            raise InputEofError("truncated varint")
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            if b == 0 and i > 0:
                raise DataError("non-minimal varint")
            return v, pos
    raise DataError("varint too long")


@dataclass(frozen=True)
class XzFilter:
    fid: int
    props: bytes = b""


@dataclass
class XzBlock:
    """Parsed block metadata (for random access / parallel decode)."""

    filters: list[XzFilter]
    header_size: int
    data_off: int          # offset of compressed payload in the stream image
    comp_size: int
    uncomp_size: int
    unpadded_size: int     # header + compressed + check (no padding)


def _check_compute(check: int, data: bytes) -> bytes:
    if check == CHECK_NONE:
        return b""
    if check == CHECK_CRC32:
        return crc32(data).to_bytes(4, "little")
    if check == CHECK_CRC64:
        return crc64(data).to_bytes(8, "little")
    if check == CHECK_SHA256:
        return sha256(data)
    raise UnsupportedError(f"xz check {check:#x}")


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------

def _stream_header(check: int) -> bytes:
    flags = bytes([0, check])
    return MAGIC + flags + crc32(flags).to_bytes(4, "little")


def _block_header(filters: list[XzFilter]) -> bytes:
    body = bytearray()
    body.append(0)  # placeholder for size byte
    body.append(len(filters) - 1)  # flags: numFilters-1, no size fields
    for f in filters:
        body += _write_varint(f.fid)
        body += _write_varint(len(f.props))
        body += f.props
    while (len(body) + 4) % 4:
        body.append(0)
    size_total = len(body) + 4
    body[0] = size_total // 4 - 1
    return bytes(body) + crc32(bytes(body)).to_bytes(4, "little")


def encode(data: bytes, *, check: str = "crc32",
           filters: list[XzFilter] | None = None,
           dict_size: int = 1 << 24, block_size: int | None = None,
           chunk_size: int | None = None, parallel_groups: bool = True,
           effort: int = 9, threads: int | None = None,
           engine: str = "host") -> bytes:
    """Encode bytes into a one-stream .xz image, on the host.

    ``filters``: optional pre-filters (delta/branch) applied before the
    LZMA2 stage, in xz filter-chain order.  ``block_size`` splits input
    into independently decodable blocks (reference writes a single block).
    ``threads``: block-parallel LZMA2 encoding over dict-reset groups
    (the MtCoder-backed xz path, ``XzEnc.c:431-450``); the stream is
    byte-identical at any thread count.  ``engine`` must be ``"host"``:
    encode has no device engine here, and others raise UnsupportedError.
    """
    if engine != "host":
        raise UnsupportedError(f"xz encode runs on the host; engine "
                               f"{engine!r} is not supported")
    check_id = _CHECK_NAMES[check]
    out = bytearray(_stream_header(check_id))
    pre = filters or []
    records = []  # (unpadded, uncomp)
    bsize = block_size or max(len(data), 1)
    pos = 0
    while pos < len(data) or (pos == 0 and not data):
        blk = data[pos:pos + bsize]
        payload = blk
        chain: list[XzFilter] = []
        for f in pre:
            payload = _apply_filter(f, payload, encoding=True)
            chain.append(f)
        if threads is not None and threads != 1 and parallel_groups:
            from ..parallel.host_pool import encode_lzma2_mt
            stream, prop = encode_lzma2_mt(
                payload, dict_size=dict_size,
                chunk_size=chunk_size or (1 << 20), threads=threads,
                effort=effort)
        else:
            stream, prop = native.lzma2_encode(payload, dict_size, chunk_size,
                                               parallel_groups, effort=effort)
        chain = chain + [XzFilter(FILTER_LZMA2, bytes([prop]))]
        hdr = _block_header(chain)
        chk = _check_compute(check_id, blk)
        out += hdr
        out += stream
        pad = (-len(stream)) % 4
        out += bytes(pad)
        out += chk
        records.append((len(hdr) + len(stream) + len(chk), len(blk)))
        pos += len(blk)
        if not data:
            break

    # index
    index = bytearray([0])
    index += _write_varint(len(records))
    for unpadded, uncomp in records:
        index += _write_varint(unpadded)
        index += _write_varint(uncomp)
    while len(index) % 4:
        index.append(0)
    index += crc32(bytes(index)).to_bytes(4, "little")
    out += index

    # footer
    backward = (len(index)) // 4 - 1
    ftr = backward.to_bytes(4, "little") + bytes([0, check_id])
    out += crc32(ftr).to_bytes(4, "little") + ftr + FOOTER_MAGIC
    return bytes(out)


def _apply_filter(f: XzFilter, data: bytes, *, encoding: bool) -> bytes:
    if f.fid == FILTER_DELTA:
        if len(f.props) != 1:
            raise DataError("bad delta props")
        dist = f.props[0] + 1
        if encoding:
            return FLT.delta_encode(data, dist)[0]
        return FLT.delta_decode(data, dist)[0]
    if f.fid in _BRANCH_FILTERS:
        ip = int.from_bytes(f.props[:4], "little") if len(f.props) == 4 else 0
        if f.fid == FILTER_X86:
            return FLT.x86_convert(data, ip, encoding)[0]
        return _BRANCH_FILTERS[f.fid](data, ip, encoding)
    raise UnsupportedError(f"xz filter {f.fid:#x}")


# ---------------------------------------------------------------------------
# read
# ---------------------------------------------------------------------------

def _parse_stream_header(data: bytes, pos: int = 0) -> int:
    if data[pos:pos + 6] != MAGIC:
        raise ArchiveError("bad xz magic")
    flags = data[pos + 6:pos + 8]
    if crc32(flags) != int.from_bytes(data[pos + 8:pos + 12], "little"):
        raise CrcError("stream header CRC")
    if flags[0] != 0 or (flags[1] & 0xF0):
        raise UnsupportedError("bad stream flags")
    return flags[1] & 0x0F


def _parse_block_header(data: bytes, pos: int) -> XzBlock:
    start = pos
    size_total = (data[pos] + 1) * 4
    hdr = data[pos:pos + size_total]
    if len(hdr) < size_total:
        raise InputEofError("truncated block header")
    if crc32(hdr[:-4]) != int.from_bytes(hdr[-4:], "little"):
        raise CrcError("block header CRC")
    flags = hdr[1]
    nfilters = (flags & 0x03) + 1
    if flags & 0x3C:
        raise UnsupportedError("reserved block flags")
    has_comp = bool(flags & 0x40)
    has_uncomp = bool(flags & 0x80)
    p = 2
    comp_size = uncomp_size = -1
    if has_comp:
        comp_size, p = _read_varint(hdr, p)
    if has_uncomp:
        uncomp_size, p = _read_varint(hdr, p)
    fl = []
    for _ in range(nfilters):
        fid, p = _read_varint(hdr, p)
        psz, p = _read_varint(hdr, p)
        fl.append(XzFilter(fid, bytes(hdr[p:p + psz])))
        p += psz
    if any(hdr[p:-4]):
        raise DataError("nonzero block header padding")
    return XzBlock(filters=fl, header_size=size_total,
                   data_off=start + size_total, comp_size=comp_size,
                   uncomp_size=uncomp_size, unpadded_size=-1)


def _decode_block_payload(stream_img: bytes, blk: XzBlock, comp_size: int,
                          engine: str, device) -> bytes:
    """Run the block's filter chain in reverse over its payload."""
    payload = stream_img[blk.data_off:blk.data_off + comp_size]
    if not blk.filters or blk.filters[-1].fid != FILTER_LZMA2:
        raise UnsupportedError("last xz filter must be LZMA2")
    lz = blk.filters[-1]
    if len(lz.props) != 1:
        raise DataError("bad LZMA2 props size")
    out = lzma2_uncompress(payload, lz.props[0], engine=engine, device=device)
    for f in reversed(blk.filters[:-1]):
        out = _apply_filter(f, out, encoding=False)
    return out


def decode(data: bytes, *, engine: str = "device", device="cuda",
           verify: bool = True) -> bytes:
    """Decode (and verify) a whole .xz image, possibly multi-stream.

    Each block's LZMA2 payload goes to ``lzma2_uncompress`` with ``engine``
    ("device", "hybrid" or "host") and ``device`` ("cuda" or "cpu", the
    kernel's plain version)."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        # skip stream padding (4-byte zero groups)
        while pos + 4 <= n and data[pos:pos + 4] == b"\0\0\0\0":
            pos += 4
        if pos >= n:
            break
        check_id = _parse_stream_header(data, pos)
        stream_base = pos
        pos += 12
        check_size = _CHECK_SIZES.get(check_id)
        if check_size is None:
            raise UnsupportedError(f"xz check {check_id:#x}")
        records = []
        while True:
            if pos >= n:
                raise InputEofError("missing xz index")
            if data[pos] == 0:  # index indicator
                break
            blk = _parse_block_header(data, pos)
            # compressed size unknown until decoded unless declared: decode
            # by scanning the LZMA2 stream for its end
            if blk.comp_size >= 0:
                comp = blk.comp_size
            else:
                _chunks, end = framing.scan(data, blk.data_off)
                comp = end - blk.data_off
            body = _decode_block_payload(data, blk, comp, engine, device)
            if blk.uncomp_size >= 0 and blk.uncomp_size != len(body):
                raise DataError("block uncompressed size mismatch")
            pad = (-comp) % 4
            padding = data[blk.data_off + comp:blk.data_off + comp + pad]
            if any(padding):
                raise DataError("nonzero block padding")
            cpos = blk.data_off + comp + pad
            if verify and check_size:
                stored = data[cpos:cpos + check_size]
                if _check_compute(check_id, bytes(body)) != stored:
                    raise CrcError("xz block check mismatch")
            out += body
            records.append((blk.header_size + comp + check_size, len(body)))
            pos = cpos + check_size
        # index
        ipos = pos
        pos += 1
        cnt, pos = _read_varint(data, pos)
        if cnt != len(records):
            raise DataError("index record count mismatch")
        for unpadded, uncomp in records:
            u1, pos = _read_varint(data, pos)
            u2, pos = _read_varint(data, pos)
            if u1 != unpadded or u2 != uncomp:
                raise DataError("index/blocks cross-check failed")
        while (pos - ipos) % 4:
            if data[pos]:
                raise DataError("nonzero index padding")
            pos += 1
        if crc32(data[ipos:pos]) != int.from_bytes(data[pos:pos + 4], "little"):
            raise CrcError("index CRC")
        index_size = pos + 4 - ipos
        pos += 4
        # footer
        ftr_crc = int.from_bytes(data[pos:pos + 4], "little")
        ftr = data[pos + 4:pos + 10]
        if crc32(ftr) != ftr_crc:
            raise CrcError("footer CRC")
        backward = int.from_bytes(ftr[:4], "little")
        if (backward + 1) * 4 != index_size:
            raise DataError("footer backward size mismatch")
        if ftr[4] != 0 or ftr[5] != check_id:
            raise DataError("footer flags mismatch")
        if data[pos + 10:pos + 12] != FOOTER_MAGIC:
            raise DataError("bad footer magic")
        pos += 12
    return bytes(out)


# ---------------------------------------------------------------------------
# random access: footer-first backward parse (XzIn.c:141-224, 274-306)
# ---------------------------------------------------------------------------

@dataclass
class XzStreamInfo:
    start: int
    check_id: int
    blocks: list[tuple[int, int]]  # (unpadded_size, uncomp_size)
    blocks_start: int              # offset of first block header


def read_backward(data: bytes) -> list[XzStreamInfo]:
    """Parse all streams of a (possibly concatenated) .xz image from the
    end, via footers and indexes only — no payload decoding."""
    infos: list[XzStreamInfo] = []
    end = len(data)
    while end > 0:
        while end >= 4 and data[end - 4:end] == b"\0\0\0\0":
            end -= 4
        if end == 0:
            break
        if end < 12 or data[end - 2:end] != FOOTER_MAGIC:
            raise ArchiveError("bad xz footer")
        ftr = data[end - 8:end - 2]
        if crc32(ftr) != int.from_bytes(data[end - 12:end - 8], "little"):
            raise CrcError("footer CRC")
        backward = int.from_bytes(ftr[:4], "little")
        check_id = ftr[5] & 0x0F
        index_size = (backward + 1) * 4
        ipos = end - 12 - index_size
        if ipos < 0 or data[ipos] != 0:
            raise ArchiveError("bad xz index position")
        # index CRC (last 4 bytes of the index record) — Xz_ReadIndex
        # validates it before trusting any block size (XzIn.c:141-224)
        if crc32(data[ipos:end - 16]) != int.from_bytes(
                data[end - 16:end - 12], "little"):
            raise CrcError("index CRC")
        p = ipos + 1
        cnt, p = _read_varint(data, p)
        blocks = []
        total_unpadded = 0
        for _ in range(cnt):
            unpadded, p = _read_varint(data, p)
            uncomp, p = _read_varint(data, p)
            blocks.append((unpadded, uncomp))
            total_unpadded += unpadded + ((-unpadded) % 4)
        blocks_start = ipos - total_unpadded
        start = blocks_start - 12
        if start < 0 or data[start:start + 6] != MAGIC:
            raise ArchiveError("xz stream header not found (backward)")
        infos.append(XzStreamInfo(start=start, check_id=check_id,
                                  blocks=blocks, blocks_start=blocks_start))
        end = start
    infos.reverse()
    return infos


# ---------------------------------------------------------------------------
# streaming push decoder (XzUnpacker_Code state machine, XzDec.c:604-870)
# ---------------------------------------------------------------------------

class XzStreamDecoder:
    """Incremental .xz decoder: feed bytes, collect output, bounded memory.

    The reference's push parser walks STREAM_HEADER → BLOCK_HEADER → BLOCK →
    BLOCK_FOOTER → … → INDEX → FOOTER → PADDING (``EXzState``,
    ``Xz.h:182-192``); this class keeps the same progression.  A block's
    LZMA2 payload goes to the native resumable decoder, which holds the
    dictionary window and keeps no input, so memory stays within the
    dictionary and the pieces fed.  One pre-filter (x86, ARM, ARMT, PPC,
    SPARC, IA64 or delta) runs through ``StreamingBranchFilter``.

    Usage::

        dec = XzStreamDecoder(sink=chunks.append)
        dec.feed(part1); dec.feed(part2); dec.finish()
    """

    def __init__(self, sink, *, verify: bool = True):
        self.sink = sink
        self.verify = verify
        self.buf = bytearray()
        self.state = "STREAM_HEADER"
        self.check_id = 0
        self.records = []
        self.block = None
        self.n2 = None
        self.block_comp = 0
        self.block_uncomp = 0
        self.sfilter = None
        self.finished_streams = 0

    def _have(self, n: int) -> bool:
        return len(self.buf) >= n

    def _take(self, n: int) -> bytes:
        r = bytes(self.buf[:n])
        del self.buf[:n]
        return r

    def feed(self, data: bytes) -> None:
        self.buf += data
        while self._step():
            pass

    def finish(self) -> None:
        self.feed(b"")
        # trailing stream padding is legal
        while self.state == "PADDING" and self._have(4):
            if any(self.buf[:4]):
                break
            self._take(4)
        if self.state == "PADDING" and not any(self.buf):
            self.buf.clear()
            self.state = "DONE" if self.finished_streams else self.state
        if self.state not in ("DONE",) and not (
                self.state == "PADDING" and self.finished_streams):
            raise InputEofError(f"xz stream ended in state {self.state}")

    def _step(self) -> bool:
        st = self.state
        if st == "STREAM_HEADER":
            if not self._have(12):
                return False
            hdr = self._take(12)
            self.check_id = _parse_stream_header(hdr, 0)
            self.records = []
            self.state = "BLOCK_HEADER"
            return True
        if st == "BLOCK_HEADER":
            if not self._have(1):
                return False
            if self.buf[0] == 0:
                self.state = "INDEX"
                return True
            size_total = (self.buf[0] + 1) * 4
            if not self._have(size_total):
                return False
            blk = _parse_block_header(bytes(self.buf[:size_total]), 0)
            self._take(size_total)
            self._begin_block(blk)
            return True
        if st == "BLOCK":
            return self._block_step()
        if st == "BLOCK_TAIL":
            pad = (-self.block_comp) % 4
            csz = _CHECK_SIZES[self.check_id]
            if not self._have(pad + csz):
                return False
            tail = self._take(pad + csz)
            if any(tail[:pad]):
                raise DataError("nonzero block padding")
            if self.verify and csz:
                if self._digest.digest() != tail[pad:]:
                    raise CrcError("xz block check mismatch (streaming)")
            self.records.append(
                (self.block.header_size + self.block_comp + csz,
                 self.block_uncomp))
            self.state = "BLOCK_HEADER"
            return True
        if st == "INDEX":
            return self._index_step()
        if st == "FOOTER":
            if not self._have(12):
                return False
            ftr = self._take(12)
            if crc32(ftr[4:10]) != int.from_bytes(ftr[:4], "little"):
                raise CrcError("footer CRC")
            if ftr[10:12] != FOOTER_MAGIC:
                raise DataError("bad footer magic")
            self.finished_streams += 1
            self.state = "PADDING"
            return True
        if st == "PADDING":
            while self._have(4) and not any(self.buf[:4]):
                self._take(4)
            if self._have(1) and self.buf[0] != 0:
                self.state = "STREAM_HEADER"
                return True
            return False
        return False

    def _begin_block(self, blk) -> None:
        from ..streams.extract7z import StreamingBranchFilter
        if not blk.filters or blk.filters[-1].fid != FILTER_LZMA2:
            raise UnsupportedError("streaming: last filter must be LZMA2")
        self.block = blk
        self.block_comp = 0
        self.block_uncomp = 0
        pre = blk.filters[:-1]
        self._digest = _DigestState(self.check_id)
        # the block check covers the final decoded bytes (after the
        # filters), so the digest taps the output end of the chain
        sink = self._window_sink(self.sink)
        self.sfilter = None
        if pre:
            if len(pre) != 1:
                raise UnsupportedError("streaming: at most one pre-filter")
            f = pre[0]
            m = {FILTER_X86: 0x03030103, FILTER_ARM: 0x03030501,
                 FILTER_ARMT: 0x03030701, FILTER_PPC: 0x03030205,
                 FILTER_SPARC: 0x03030805, FILTER_IA64: 0x03030401,
                 FILTER_DELTA: 0x03}.get(f.fid)
            if m is None:
                raise UnsupportedError(f"streaming filter {f.fid:#x}")
            self.sfilter = StreamingBranchFilter(m, f.props, sink)
            sink = self.sfilter.write
        self.n2 = native.Lzma2StreamDecoder(
            framing.decode_dict_prop(blk.filters[-1].props[0]))
        self._bsink = sink
        self.state = "BLOCK"

    def _window_sink(self, sink):
        def write(data: bytes):
            self._digest.update(data)
            self.block_uncomp += len(data)
            sink(data)
        return write

    def _block_step(self) -> bool:
        """Feed the buffered input to the block's decoder and pass on what
        it decoded; True while it makes progress."""
        if not self.buf:
            return False
        consumed = self.n2.feed(self.buf, finish=False)
        if consumed:
            self._take(consumed)
            self.block_comp += consumed
            out = self.n2.read(-1)
            if out:
                self._bsink(out)
        if self.n2.done:
            if self.sfilter is not None:
                self.sfilter.close()
            self.n2.close()
            self.n2 = None
            self.state = "BLOCK_TAIL"
            return True
        return bool(consumed)

    def _index_step(self) -> bool:
        # need the whole index + its CRC; parse varints incrementally
        if not self._have(2):
            return False
        try:
            pos = 1
            cnt, pos = _read_varint(self.buf, pos)
            recs = []
            for _ in range(cnt):
                a, pos = _read_varint(self.buf, pos)
                b, pos = _read_varint(self.buf, pos)
                recs.append((a, b))
            while pos % 4:
                if pos >= len(self.buf):
                    raise InputEofError("index padding")
                if self.buf[pos]:
                    raise DataError("nonzero index padding")
                pos += 1
            if not self._have(pos + 4):
                return False
        except InputEofError:
            return False
        idx = self._take(pos)
        stored = int.from_bytes(self._take(4), "little")
        if crc32(idx) != stored:
            raise CrcError("index CRC")
        if recs != self.records:
            raise DataError("index/blocks cross-check failed (streaming)")
        self.state = "FOOTER"
        return True


class _DigestState:
    """The rolling block check of one block (none, CRC32, CRC64 or
    SHA-256)."""

    def __init__(self, check_id: int):
        self.check_id = check_id
        if check_id == CHECK_SHA256:
            self._h = hashlib.sha256()
        else:
            self.value = 0

    def update(self, data: bytes) -> None:
        if self.check_id == CHECK_CRC32:
            self.value = crc32(data, self.value)
        elif self.check_id == CHECK_CRC64:
            self.value = crc64(data, self.value)
        elif self.check_id == CHECK_SHA256:
            self._h.update(data)

    def digest(self) -> bytes:
        if self.check_id == CHECK_CRC32:
            return self.value.to_bytes(4, "little")
        if self.check_id == CHECK_CRC64:
            return self.value.to_bytes(8, "little")
        if self.check_id == CHECK_SHA256:
            return self._h.digest()
        return b""
