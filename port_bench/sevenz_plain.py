"""A plain reference of 7z extraction and of the archive 7-Zip writes, in
the standard library alone.

It reads a ``.7z`` archive as the format describes it
(https://7-zip.org/7z.html and the LZMA SDK's ``7zFormat.txt``): the
signature header and its CRC, the next header (LZMA-coded or plain) and its
CRC, the pack, unpack and substreams records, and the files' names, times
and attributes. It decodes each folder with the standard library's ``lzma``
in ``FORMAT_RAW``: LZMA2 (``FILTER_LZMA2``) or LZMA (``FILTER_LZMA1``)
behind at most one branch or delta filter (``FILTER_X86`` for BCJ,
``FILTER_DELTA`` ...), or a Copy coder, and checks every folder and file
CRC32 with ``zlib``. BCJ2 and PPMd folders are outside it
(``NotImplementedError``).

It also writes archives as 7-Zip's ``7zOut.cpp`` lays them out
(``archive``): LZMA2 (or LZMA) folders, alone or behind x86 BCJ (coders
``[LZMA2, BCJ]`` bound ``(1, 0)``, as ``7zDec.c`` reads them), from packed
streams the caller made, a CRC32 a file in the substreams record, names,
mtimes and attributes, and the header LZMA-coded by liblzma; ``cut`` cuts a
folder's bytes into files.

It imports nothing of this repository and no kernel: it is the yardstick
the device route of ``containers/sevenzip.extract`` is held against.  The
benchmark keeps a copy of this file, ``port_bench/sevenz_plain.py``, byte
for byte.
"""

from __future__ import annotations

import dataclasses
import lzma
import math
import zlib

SIGNATURE = b"7z\xbc\xaf\x27\x1c"

(K_END, K_HEADER, K_ARCHIVE_PROPERTIES, K_ADDITIONAL_STREAMS, K_MAIN_STREAMS,
 K_FILES_INFO, K_PACK_INFO, K_UNPACK_INFO, K_SUBSTREAMS_INFO, K_SIZE, K_CRC,
 K_FOLDER, K_CODERS_UNPACK_SIZE, K_NUM_UNPACK_STREAM, K_EMPTY_STREAM,
 K_EMPTY_FILE, K_ANTI, K_NAME, K_CTIME, K_ATIME, K_MTIME, K_WIN_ATTRIB,
 K_COMMENT, K_ENCODED_HEADER) = range(24)

COPY, LZMA2, LZMA, DELTA = 0x00, 0x21, 0x030101, 0x03
BCJ, PPC, IA64, ARM, ARMT, SPARC = (0x03030103, 0x03030205, 0x03030401,
                                    0x03030501, 0x03030701, 0x03030805)
BRANCH = {BCJ: lzma.FILTER_X86, PPC: lzma.FILTER_POWERPC,
          IA64: lzma.FILTER_IA64, ARM: lzma.FILTER_ARM,
          ARMT: lzma.FILTER_ARMTHUMB, SPARC: lzma.FILTER_SPARC}


class CrcMismatch(ValueError):
    """A stored CRC32 that the decoded bytes do not have."""


@dataclasses.dataclass
class Coder:
    method: int
    n_in: int
    n_out: int
    props: bytes


@dataclasses.dataclass
class Folder:
    coders: list
    bonds: list            # (in stream, out stream)
    packed: list           # in streams fed by packed streams, in order
    sizes: list = dataclasses.field(default_factory=list)   # per out stream
    crc: int | None = None

    def final_out(self) -> int:
        bound = {o for _, o in self.bonds}
        return next(o for o in range(len(self.sizes)) if o not in bound)

    @property
    def size(self) -> int:
        return self.sizes[self.final_out()]


@dataclasses.dataclass
class Entry:
    name: str
    size: int = 0
    crc: int | None = None
    has_stream: bool = True
    is_dir: bool = False
    mtime: int | None = None
    attrib: int | None = None
    folder: int = -1
    offset: int = 0


@dataclasses.dataclass
class Archive:
    pack_start: int = 32
    pack_sizes: list = dataclasses.field(default_factory=list)
    folders: list = dataclasses.field(default_factory=list)
    streams: list = dataclasses.field(default_factory=list)  # per folder
    entries: list = dataclasses.field(default_factory=list)

    def packed_spans(self, fi: int) -> list:
        """(offset in the archive, size) of folder ``fi``'s packed
        streams, in the folder's order."""
        first = sum(len(f.packed) for f in self.folders[:fi])
        at = self.pack_start + sum(self.pack_sizes[:first])
        out = []
        for size in self.pack_sizes[first:][:len(self.folders[fi].packed)]:
            out.append((at, size))
            at += size
        return out


class _In:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("7z header ends early")
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("7z header ends early")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def number(self) -> int:
        """A 7z number: the count of leading one bits of the first byte
        is the count of little-endian bytes that follow, above which the
        first byte's remaining bits stand."""
        first, mask, value = self.byte(), 0x80, 0
        for i in range(8):
            if not first & mask:
                return value | (first & (mask - 1)) << (8 * i)
            value |= self.byte() << (8 * i)
            mask >>= 1
        return value

    def bits(self, n: int) -> list:
        out = []
        for i in range(n):
            if i % 8 == 0:
                b = self.byte()
            out.append(bool(b & (0x80 >> (i % 8))))
        return out

    def defined(self, n: int) -> list:
        return [True] * n if self.byte() else self.bits(n)

    def crcs(self, n: int) -> list:
        return [int.from_bytes(self.take(4), "little") if d else None
                for d in self.defined(n)]


def _folder(r: _In) -> Folder:
    coders = []
    for _ in range(r.number()):
        flag = r.byte()
        if flag & 0x80:
            raise NotImplementedError("alternative coder methods")
        method = int.from_bytes(r.take(flag & 0x0F), "big")
        n_in = n_out = 1
        if flag & 0x10:
            n_in, n_out = r.number(), r.number()
        props = r.take(r.number()) if flag & 0x20 else b""
        coders.append(Coder(method, n_in, n_out, props))
    n_in = sum(c.n_in for c in coders)
    bonds = [(r.number(), r.number())
             for _ in range(sum(c.n_out for c in coders) - 1)]
    bound_in = {i for i, _ in bonds}
    if n_in - len(bonds) == 1:
        packed = [next(i for i in range(n_in) if i not in bound_in)]
    else:
        packed = [r.number() for _ in range(n_in - len(bonds))]
    return Folder(coders, bonds, packed)


def _streams_info(r: _In, ar: Archive) -> None:
    """The pack, unpack and substreams records into ``ar``."""
    counts = None
    sizes = crcs = None
    while (kind := r.number()) != K_END:
        if kind == K_PACK_INFO:
            ar.pack_start = 32 + r.number()
            n = r.number()
            while (sub := r.number()) != K_END:
                if sub == K_SIZE:
                    ar.pack_sizes = [r.number() for _ in range(n)]
                elif sub == K_CRC:
                    r.crcs(n)
                else:
                    r.take(r.number())
        elif kind == K_UNPACK_INFO:
            if r.number() != K_FOLDER:
                raise ValueError("7z unpack info without folders")
            n = r.number()
            if r.byte():
                raise NotImplementedError("external folders")
            ar.folders = [_folder(r) for _ in range(n)]
            if r.number() != K_CODERS_UNPACK_SIZE:
                raise ValueError("7z folders without unpack sizes")
            for f in ar.folders:
                f.sizes = [r.number() for _ in range(sum(c.n_out
                                                         for c in f.coders))]
            while (sub := r.number()) != K_END:
                if sub == K_CRC:
                    for f, crc in zip(ar.folders, r.crcs(n)):
                        f.crc = crc
                else:
                    r.take(r.number())
        elif kind == K_SUBSTREAMS_INFO:
            counts = [1] * len(ar.folders)
            while (sub := r.number()) != K_END:
                if sub == K_NUM_UNPACK_STREAM:
                    counts = [r.number() for _ in ar.folders]
                elif sub == K_SIZE:
                    sizes = []
                    for f, k in zip(ar.folders, counts):
                        part = [r.number() for _ in range(k - 1)] if k else []
                        sizes.append(part + [f.size - sum(part)] if k else [])
                elif sub == K_CRC:
                    need = sum(k for f, k in zip(ar.folders, counts)
                               if not (k == 1 and f.crc is not None))
                    crcs = iter(r.crcs(need))
                else:
                    r.take(r.number())
        else:
            raise ValueError(f"7z streams record {kind:#x}")
    counts = counts or [1] * len(ar.folders)
    if sizes is None:
        if any(k > 1 for k in counts):
            raise ValueError("7z substreams without sizes")
        sizes = [[f.size] if k else [] for f, k in zip(ar.folders, counts)]
    ar.streams = []
    for f, k, part in zip(ar.folders, counts, sizes):
        if k == 1 and f.crc is not None:
            ar.streams.append([(part[0], f.crc)])
        else:
            ar.streams.append([(s, next(crcs) if crcs else None)
                               for s in part])


def _files_info(r: _In, ar: Archive) -> None:
    entries = [Entry("") for _ in range(r.number())]
    empty_stream = [False] * len(entries)
    empty_file: list = []
    while (kind := r.number()) != K_END:
        end = r.number() + r.pos
        if kind == K_EMPTY_STREAM:
            empty_stream = r.bits(len(entries))
        elif kind == K_EMPTY_FILE:
            empty_file = r.bits(sum(empty_stream))
        elif kind == K_NAME:
            if r.byte():
                raise NotImplementedError("external names")
            names = r.take(end - r.pos).decode("utf-16-le").split("\0")
            for e, name in zip(entries, names):
                e.name = name
        elif kind in (K_MTIME, K_WIN_ATTRIB):
            defined = r.defined(len(entries))
            if r.byte():
                raise NotImplementedError("external times or attributes")
            width = 8 if kind == K_MTIME else 4
            for e, d in zip(entries, defined):
                if d:
                    value = int.from_bytes(r.take(width), "little")
                    if kind == K_MTIME:
                        e.mtime = value
                    else:
                        e.attrib = value
        r.pos = end
    streams = iter((fi, size, crc) for fi, part in enumerate(ar.streams)
                   for size, crc in part)
    offsets = [0] * len(ar.folders)
    empties = iter(empty_file)
    for e, empty in zip(entries, empty_stream):
        if empty:
            e.has_stream = False
            e.is_dir = not next(empties, False)
            continue
        e.folder, e.size, e.crc = next(streams)
        e.offset = offsets[e.folder]
        offsets[e.folder] += e.size
    ar.entries = entries


def _filters(f: Folder) -> list | None:
    """The ``lzma`` filter chain of a folder, or None for a Copy coder."""
    def main(c: Coder):
        if c.method == LZMA2:
            p = c.props[0]
            return {"id": lzma.FILTER_LZMA2, "dict_size": 0xFFFFFFFF if
                    p == 40 else (2 | (p & 1)) << (p // 2 + 11)}
        if c.method == LZMA:
            d = c.props[0]
            return {"id": lzma.FILTER_LZMA1, "lc": d % 9, "lp": d // 9 % 5,
                    "pb": d // 45,
                    "dict_size": int.from_bytes(c.props[1:5], "little")}
        raise NotImplementedError(f"7z method {c.method:#x}")

    if len(f.coders) == 1 and f.packed == [0]:
        c = f.coders[0]
        return None if c.method == COPY else [main(c)]
    if len(f.coders) == 2 and f.bonds == [(1, 0)] and f.packed == [0]:
        c, flt = f.coders
        if flt.method in BRANCH:
            return [{"id": BRANCH[flt.method]}, main(c)]
        if flt.method == DELTA:
            return [{"id": lzma.FILTER_DELTA, "dist": flt.props[0] + 1},
                    main(c)]
    raise NotImplementedError("7z folder of another shape")


def decode_folder(data: bytes, ar: Archive, fi: int) -> bytes:
    """Folder ``fi``'s output, its CRC32 checked where it has one."""
    f = ar.folders[fi]
    [(at, size)] = ar.packed_spans(fi)
    packed = data[at:at + size]
    filters = _filters(f)
    if filters is None:
        out = packed[:f.size]
    else:
        dec = lzma.LZMADecompressor(lzma.FORMAT_RAW, filters=filters)
        out = dec.decompress(packed, max_length=f.size)
    if len(out) != f.size:
        raise ValueError(f"7z folder {fi}: {len(out)} bytes of {f.size}")
    if f.crc is not None and zlib.crc32(out) != f.crc:
        raise CrcMismatch(f"7z folder {fi}")
    return out


def read(data: bytes) -> Archive:
    """The archive's records, its LZMA-coded header decoded."""
    if data[:6] != SIGNATURE:
        raise ValueError("no 7z signature")
    if zlib.crc32(data[12:32]) != int.from_bytes(data[8:12], "little"):
        raise CrcMismatch("7z start header")
    at = 32 + int.from_bytes(data[12:20], "little")
    head = data[at:at + int.from_bytes(data[20:28], "little")]
    if zlib.crc32(head) != int.from_bytes(data[28:32], "little"):
        raise CrcMismatch("7z next header")
    r = _In(head)
    kind = r.number()
    if kind == K_ENCODED_HEADER:
        packed = Archive()
        _streams_info(r, packed)
        r = _In(decode_folder(data, packed, 0))
        kind = r.number()
    if kind != K_HEADER:
        raise ValueError(f"7z header record {kind:#x}")
    ar = Archive()
    while (kind := r.number()) != K_END:
        if kind == K_MAIN_STREAMS:
            _streams_info(r, ar)
        elif kind == K_FILES_INFO:
            _files_info(r, ar)
        else:
            raise NotImplementedError(f"7z header record {kind:#x}")
    return ar


def extract(data: bytes) -> dict:
    """Every file's bytes by name, in archive order (a directory left
    out), each folder's and file's CRC32 checked."""
    ar = read(data)
    bodies: dict = {}
    out = {}
    for e in ar.entries:
        if e.is_dir:
            continue
        if not e.has_stream:
            out[e.name] = b""
            continue
        if e.folder not in bodies:
            bodies[e.folder] = decode_folder(data, ar, e.folder)
        blob = bodies[e.folder][e.offset:e.offset + e.size]
        if e.crc is not None and zlib.crc32(blob) != e.crc:
            raise CrcMismatch(f"7z file {e.name}")
        out[e.name] = blob
    return out


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

class _Out:
    """A header being written, with 7-Zip's number coding
    (``7zOut.cpp``, ``WriteNumber``)."""

    def __init__(self):
        self.buf = bytearray()

    def byte(self, b: int) -> None:
        self.buf.append(b)

    def number(self, v: int) -> None:
        first, mask, n = 0, 0x80, 0
        while n < 8 and v >= 1 << (7 * (n + 1)):
            first |= mask
            mask >>= 1
            n += 1
        self.buf.append(first | (v >> (8 * n) if n < 8 else 0))
        self.buf += (v & ((1 << (8 * n)) - 1)).to_bytes(n, "little")

    def u32(self, v: int) -> None:
        self.buf += v.to_bytes(4, "little")

    def coder(self, method: int, props: bytes) -> None:
        size = max(1, (method.bit_length() + 7) // 8)
        self.byte(size | (0x20 if props else 0))
        self.buf += method.to_bytes(size, "big")
        if props:
            self.number(len(props))
            self.buf += props


def _pack_info(w: _Out, offset: int, sizes: list) -> None:
    w.byte(K_PACK_INFO)
    w.number(offset)
    w.number(len(sizes))
    w.byte(K_SIZE)
    for s in sizes:
        w.number(s)
    w.byte(K_END)


def header(folders: list) -> bytes:
    """The plain header of an archive of ``folders``: each a dict with
    ``packed`` (the LZMA2 stream with its end marker), ``size`` (its
    output), ``bcj`` (x86 BCJ behind the LZMA2 coder), ``dict_prop`` and
    ``files``, a list of ``(name, size, crc32, mtime, attrib)``; a folder
    with ``lzma_props`` (5 bytes) has an LZMA coder in the LZMA2 coder's
    place and ``packed`` is an LZMA stream."""
    w = _Out()
    w.byte(K_HEADER)
    w.byte(K_MAIN_STREAMS)
    _pack_info(w, 0, [len(f["packed"]) for f in folders])
    w.byte(K_UNPACK_INFO)
    w.byte(K_FOLDER)
    w.number(len(folders))
    w.byte(0)
    for f in folders:
        w.number(2 if f["bcj"] else 1)
        if "lzma_props" in f:
            w.coder(LZMA, f["lzma_props"])
        else:
            w.coder(LZMA2, bytes([f["dict_prop"]]))
        if f["bcj"]:
            w.coder(BCJ, b"")
            w.number(1)             # bond: the BCJ coder's in stream 1
            w.number(0)             # takes the LZMA2 coder's out stream 0
    w.byte(K_CODERS_UNPACK_SIZE)
    for f in folders:
        for _ in range(2 if f["bcj"] else 1):
            w.number(f["size"])
    w.byte(K_END)
    w.byte(K_SUBSTREAMS_INFO)
    if any(len(f["files"]) != 1 for f in folders):
        w.byte(K_NUM_UNPACK_STREAM)
        for f in folders:
            w.number(len(f["files"]))
    if any(len(f["files"]) > 1 for f in folders):
        w.byte(K_SIZE)
        for f in folders:
            for _name, size, *_ in f["files"][:-1]:
                w.number(size)
    w.byte(K_CRC)
    w.byte(1)                       # every CRC defined
    for f in folders:
        for _name, _size, crc, *_ in f["files"]:
            w.u32(crc)
    w.byte(K_END)
    w.byte(K_END)
    entries = [e for f in folders for e in f["files"]]
    w.byte(K_FILES_INFO)
    w.number(len(entries))
    names = b"".join((e[0] + "\0").encode("utf-16-le") for e in entries)
    w.byte(K_NAME)
    w.number(len(names) + 1)
    w.byte(0)
    w.buf += names
    for kind, width, at in ((K_MTIME, 8, 3), (K_WIN_ATTRIB, 4, 4)):
        w.byte(kind)
        w.number(len(entries) * width + 2)
        w.byte(1)                   # every entry defined
        w.byte(0)                   # not external
        for e in entries:
            w.buf += e[at].to_bytes(width, "little")
    w.byte(K_END)
    w.byte(K_END)
    return bytes(w.buf)


def lzma1_props(h: dict) -> bytes:
    """The 5 property bytes of an LZMA coder: lc, lp and pb in one byte,
    then the dictionary size."""
    return bytes([(h["pb"] * 5 + h["lp"]) * 9 + h["lc"]]) + \
        h["dict_size"].to_bytes(4, "little")


def encoded_header(plain: bytes, packed_at: int, h: dict) -> tuple:
    """(packed header, the kEncodedHeader record that points at it):
    ``plain`` LZMA-coded by liblzma with the parameters ``h`` (``preset``,
    ``dict_size``, ``nice_len``, ``lc``, ``lp``, ``pb``), its packed
    stream ``packed_at`` bytes after the start header, with the CRC32 of
    ``plain``, as ``7zOut.cpp`` writes it."""
    packed = lzma.compress(plain, lzma.FORMAT_RAW, filters=[{
        "id": lzma.FILTER_LZMA1, "preset": h["preset"],
        "dict_size": h["dict_size"], "nice_len": h["nice_len"],
        "lc": h["lc"], "lp": h["lp"], "pb": h["pb"]}])
    w = _Out()
    w.byte(K_ENCODED_HEADER)
    _pack_info(w, packed_at, [len(packed)])
    w.byte(K_UNPACK_INFO)
    w.byte(K_FOLDER)
    w.number(1)
    w.byte(0)
    w.number(1)
    w.coder(LZMA, lzma1_props(h))
    w.byte(K_CODERS_UNPACK_SIZE)
    w.number(len(plain))
    w.byte(K_CRC)
    w.byte(1)
    w.u32(zlib.crc32(plain))
    w.byte(K_END)
    w.byte(K_END)
    return packed, bytes(w.buf)


def archive(folders: list, h: dict) -> bytes:
    """The ``.7z`` image of ``folders`` (as ``header`` takes them): the
    signature header, the folders' packed streams, the header LZMA-coded
    with the parameters ``h`` (as ``encoded_header`` takes them) and its
    record."""
    body = b"".join(f["packed"] for f in folders)
    packed, record = encoded_header(header(folders), len(body), h)
    tail = (len(body) + len(packed)).to_bytes(8, "little") + \
        len(record).to_bytes(8, "little") + \
        zlib.crc32(record).to_bytes(4, "little")
    start = SIGNATURE + bytes([0, 4]) + \
        zlib.crc32(tail).to_bytes(4, "little") + tail
    return start + body + packed + record


def cut(raw: bytes, rng, lo: int, hi: int, stem: str, exts: tuple,
        attrib: int, mtime0: int) -> list:
    """``raw`` cut into files ``(name, size, crc32, mtime, attrib)``:
    sizes drawn from ``rng`` log-uniform between ``lo`` and ``hi`` bytes,
    the last file taking what is left; names ``<stem><i><ext>``, the
    extensions taken in turn; mtimes ``mtime0`` and up to 2^48 ticks after
    it."""
    files, at = [], 0
    while at < len(raw):
        size = min(int(math.exp(rng.uniform(math.log(lo), math.log(hi)))),
                   len(raw) - at)
        name = f"{stem}{len(files):03d}{exts[len(files) % len(exts)]}"
        mtime = mtime0 + rng.randrange(1 << 48)
        files.append((name, size, zlib.crc32(memoryview(raw)[at:at + size]),
                      mtime, attrib))
        at += size
    return files
