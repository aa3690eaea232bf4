""".7z archive support: reader/extractor (reference parity) plus a writer
(beyond the reference, which is read-only — ``7zIn.c``/``7zDec.c``).

Reader parity targets:
* signature + start header with CRCs (``7zIn.c:1231-1245``)
* property-ID tree: PackInfo/UnpackInfo/SubStreamsInfo/FilesInfo
  (``7zIn.c:481-1120``), 7z variable-length numbers (``7zIn.c:348-369``),
  bit vectors (``7zIn.c:431-461``)
* encoded (LZMA-compressed) metadata headers, decoded with the same folder
  machinery (``SzReadAndDecodePackedStreams``, ``7zIn.c:1147-1212``)
* folder = coder DAG with bind pairs; supported graphs: single
  {Copy, LZMA, LZMA2, PPMd}, main+branch-filter, and the 4-stream BCJ2
  shape (``CheckSupportedFolder``, ``7zDec.c:269-322``)
* per-folder and per-file CRC verification (``7zIn.c:1378-1397``)
* the fork's constant-memory streaming extraction (``7zDec.c:472-1025``)
  is provided by :mod:`..streams.extract7z`.

The writer emits single-folder-per-file archives with Copy/LZMA/LZMA2
coders (optionally BCJ-chained), readable by the reference `7zDec` — used
for golden fixtures and as a framework capability.

The port's copy of the JAX package's ``containers/sevenzip.py``; archives
and extractions are byte-identical to it.  No 7z path has a device route
in either package: LZMA and LZMA2 coders run on the host
(``engine.lzma_raw_decode`` / ``framing.decode``), with ``engine`` one of
``"auto"``, ``"native"`` or ``"python"``; any other name raises
UnsupportedError, where the JAX package runs the pure-Python decoder for
it.  PPMd folders always go to the native codec (``models/ppmd7``), as the
JAX package's do when its runtime is built.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..engine import check_engine, lzma_raw_decode, lzma_raw_encode
from ..models.lzma.spec import LzmaProps
from ..models.lzma2 import framing
from ..models.ppmd7 import codec as ppmd
from ..ops import filters as FLT
from ..utils.checksums import crc32
from ..utils.errors import (ArchiveError, CrcError, DataError, InputEofError,
                            NoArchiveError, UnsupportedError)

SIGNATURE = b"7z\xbc\xaf\x27\x1c"

# property IDs (7z.h:17-45)
K_END = 0x00
K_HEADER = 0x01
K_MAIN_STREAMS = 0x04
K_FILES_INFO = 0x05
K_PACK_INFO = 0x06
K_UNPACK_INFO = 0x07
K_SUBSTREAMS_INFO = 0x08
K_SIZE = 0x09
K_CRC = 0x0A
K_FOLDER = 0x0B
K_CODERS_UNPACK_SIZE = 0x0C
K_NUM_UNPACK_STREAM = 0x0D
K_EMPTY_STREAM = 0x0E
K_EMPTY_FILE = 0x0F
K_ANTI = 0x10
K_NAME = 0x11
K_CTIME = 0x12
K_ATIME = 0x13
K_MTIME = 0x14
K_WIN_ATTRIB = 0x15
K_ENCODED_HEADER = 0x17
K_START_POS = 0x18
K_DUMMY = 0x19

# method IDs (7zDec.c:19-27)
M_COPY = 0x00
M_LZMA = 0x030101
M_LZMA2 = 0x21
M_PPMD = 0x030401
M_BCJ = 0x03030103
M_BCJ2 = 0x0303011B
M_ARM = 0x03030501
M_ARMT = 0x03030701
M_PPC = 0x03030205
M_SPARC = 0x03030805
M_IA64 = 0x03030401
M_DELTA = 0x03

_BRANCH = {M_BCJ: None, M_ARM: FLT.arm_convert, M_ARMT: FLT.armt_convert,
           M_PPC: FLT.ppc_convert, M_SPARC: FLT.sparc_convert,
           M_IA64: FLT.ia64_convert}


class _Reader:
    """Byte reader for the 7z property tree."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise InputEofError("7z metadata truncated")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def bytes_(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise InputEofError("7z metadata truncated")
        r = self.data[self.pos:self.pos + n]
        self.pos += n
        return r

    def number(self) -> int:
        """7z variable-length number (7zIn.c:348-369)."""
        first = self.byte()
        mask = 0x80
        value = 0
        for i in range(8):
            if not (first & mask):
                value |= (first & (mask - 1)) << (8 * i)
                return value
            value |= self.byte() << (8 * i)
            mask >>= 1
        return value

    def num32(self) -> int:
        v = self.number()
        if v >= 1 << 32:
            raise DataError("number too large")
        return v

    def bit_vector(self, n: int) -> list[bool]:
        out = []
        b = 0
        mask = 0
        for _ in range(n):
            if mask == 0:
                b = self.byte()
                mask = 0x80
            out.append(bool(b & mask))
            mask >>= 1
        return out

    def bool_vector(self, n: int) -> list[bool]:
        """Bit vector with all-defined shortcut byte (7zIn.c:452-461)."""
        all_defined = self.byte()
        if all_defined:
            return [True] * n
        return self.bit_vector(n)

    def skip_data(self) -> None:
        self.bytes_(self.number())


@dataclass
class Coder:
    method: int
    num_in: int
    num_out: int
    props: bytes


@dataclass
class Folder:
    coders: list[Coder] = field(default_factory=list)
    bind_pairs: list[tuple[int, int]] = field(default_factory=list)  # (in,out)
    packed_indices: list[int] = field(default_factory=list)
    unpack_sizes: list[int] = field(default_factory=list)  # per out-stream
    crc: int | None = None

    @property
    def num_out_total(self) -> int:
        return sum(c.num_out for c in self.coders)

    @property
    def num_in_total(self) -> int:
        return sum(c.num_in for c in self.coders)

    def find_bind_pair_for_in(self, i: int) -> int:
        for k, (bin_, _bout) in enumerate(self.bind_pairs):
            if bin_ == i:
                return k
        return -1

    def find_bind_pair_for_out(self, o: int) -> int:
        for k, (_bin, bout) in enumerate(self.bind_pairs):
            if bout == o:
                return k
        return -1

    @property
    def unpack_size(self) -> int:
        """Final output size: the out-stream not consumed by a bind pair."""
        for o in range(self.num_out_total - 1, -1, -1):
            if self.find_bind_pair_for_out(o) < 0:
                return self.unpack_sizes[o]
        raise DataError("folder has no final output stream")


@dataclass
class FileEntry:
    name: str
    size: int = 0
    crc: int | None = None
    has_stream: bool = True
    is_dir: bool = False
    is_empty_file: bool = False
    mtime: int | None = None  # NTFS FILETIME (100ns ticks since 1601)
    attrib: int | None = None
    folder: int = -1
    offset_in_folder: int = 0


@dataclass
class Archive:
    pack_pos: int = 0                  # relative to end of start header (32)
    pack_sizes: list[int] = field(default_factory=list)
    folders: list[Folder] = field(default_factory=list)
    # per folder: number of substreams, their sizes and CRCs
    num_unpack_streams: list[int] = field(default_factory=list)
    sub_sizes: list[list[int]] = field(default_factory=list)
    sub_crcs: list[list[int | None]] = field(default_factory=list)
    files: list[FileEntry] = field(default_factory=list)
    folder_pack_base: list[int] = field(default_factory=list)

    def folder_pack_offset(self, fi: int) -> int:
        """Absolute offset of a folder's first packed stream in the file."""
        base = self.folder_pack_base[fi]
        return 32 + self.pack_pos + sum(self.pack_sizes[:base])


# ---------------------------------------------------------------------------
# metadata parsing
# ---------------------------------------------------------------------------

def _read_folder(r: _Reader) -> Folder:
    f = Folder()
    num_coders = r.num32()
    for _ in range(num_coders):
        flag = r.byte()
        id_size = flag & 0x0F
        mid = int.from_bytes(r.bytes_(id_size), "big")
        num_in = num_out = 1
        if flag & 0x10:
            num_in = r.num32()
            num_out = r.num32()
        props = b""
        if flag & 0x20:
            props = r.bytes_(r.num32())
        if flag & 0x80:
            raise UnsupportedError("alternative coder methods")
        f.coders.append(Coder(mid, num_in, num_out, props))
    for _ in range(f.num_out_total - 1):
        f.bind_pairs.append((r.num32(), r.num32()))
    num_packed = f.num_in_total - len(f.bind_pairs)
    if num_packed == 1:
        for i in range(f.num_in_total):
            if f.find_bind_pair_for_in(i) < 0:
                f.packed_indices.append(i)
                break
    else:
        for _ in range(num_packed):
            f.packed_indices.append(r.num32())
    return f


def _read_streams_info(r: _Reader):
    pack_pos = 0
    pack_sizes: list[int] = []
    folders: list[Folder] = []
    num_unpack = []
    sub_sizes = []
    sub_crcs = []
    while True:
        t = r.number()
        if t == K_END:
            break
        elif t == K_PACK_INFO:
            pack_pos = r.number()
            n = r.num32()
            while True:
                tt = r.number()
                if tt == K_END:
                    break
                if tt == K_SIZE:
                    pack_sizes = [r.number() for _ in range(n)]
                elif tt == K_CRC:
                    defined = r.bool_vector(n)
                    for d in defined:
                        if d:
                            r.bytes_(4)
                else:
                    r.skip_data()
        elif t == K_UNPACK_INFO:
            tt = r.number()
            if tt != K_FOLDER:
                raise ArchiveError("expected kFolder")
            num_folders = r.num32()
            external = r.byte()
            if external:
                raise UnsupportedError("external folder definitions")
            folders = [_read_folder(r) for _ in range(num_folders)]
            tt = r.number()
            if tt != K_CODERS_UNPACK_SIZE:
                raise ArchiveError("expected kCodersUnpackSize")
            for f in folders:
                f.unpack_sizes = [r.number() for _ in range(f.num_out_total)]
            while True:
                tt = r.number()
                if tt == K_END:
                    break
                if tt == K_CRC:
                    defined = r.bool_vector(num_folders)
                    for f, d in zip(folders, defined):
                        if d:
                            f.crc = int.from_bytes(r.bytes_(4), "little")
                else:
                    r.skip_data()
        elif t == K_SUBSTREAMS_INFO:
            num_unpack = [1] * len(folders)
            sizes_given = False
            while True:
                tt = r.number()
                if tt == K_END:
                    break
                if tt == K_NUM_UNPACK_STREAM:
                    num_unpack = [r.num32() for _ in folders]
                elif tt == K_SIZE:
                    sizes_given = True
                    sub_sizes = []
                    for fi, f in enumerate(folders):
                        k = num_unpack[fi]
                        if k == 0:
                            sub_sizes.append([])
                            continue
                        sizes = [r.number() for _ in range(k - 1)]
                        sizes.append(f.unpack_size - sum(sizes))
                        sub_sizes.append(sizes)
                elif tt == K_CRC:
                    # CRCs for substreams lacking a folder-level CRC
                    need = []
                    for fi, f in enumerate(folders):
                        k = num_unpack[fi]
                        if k == 1 and f.crc is not None:
                            need.append(0)
                        else:
                            need.append(k)
                    total = sum(need)
                    defined = r.bool_vector(total)
                    vals = iter(defined)
                    sub_crcs = []
                    for fi, f in enumerate(folders):
                        k = num_unpack[fi]
                        if need[fi] == 0:
                            sub_crcs.append([f.crc])
                            continue
                        row: list[int | None] = []
                        for _ in range(k):
                            if next(vals):
                                row.append(int.from_bytes(r.bytes_(4), "little"))
                            else:
                                row.append(None)
                        sub_crcs.append(row)
                else:
                    r.skip_data()
            if not sizes_given:
                sub_sizes = []
                for fi, f in enumerate(folders):
                    if num_unpack[fi] == 1:
                        sub_sizes.append([f.unpack_size])
                    elif num_unpack[fi] == 0:
                        sub_sizes.append([])
                    else:
                        raise ArchiveError("missing substream sizes")
        else:
            r.skip_data()
    if not num_unpack:
        num_unpack = [1] * len(folders)
        sub_sizes = [[f.unpack_size] for f in folders]
    if not sub_crcs:
        sub_crcs = [[f.crc] if num_unpack[fi] == 1 else [None] * num_unpack[fi]
                    for fi, f in enumerate(folders)]
    return pack_pos, pack_sizes, folders, num_unpack, sub_sizes, sub_crcs


def _assign_folder_pack_bases(ar: Archive) -> None:
    base = 0
    ar.folder_pack_base = []
    for f in ar.folders:
        ar.folder_pack_base.append(base)
        base += len(f.packed_indices)


def _read_header(r: _Reader, ar: Archive) -> None:
    while True:
        t = r.number()
        if t == K_END:
            return
        if t == K_MAIN_STREAMS:
            (ar.pack_pos, ar.pack_sizes, ar.folders, ar.num_unpack_streams,
             ar.sub_sizes, ar.sub_crcs) = _read_streams_info(r)
            _assign_folder_pack_bases(ar)
        elif t == K_FILES_INFO:
            _read_files_info(r, ar)
        else:
            r.skip_data()


def _read_files_info(r: _Reader, ar: Archive) -> None:
    num_files = r.num32()
    files = [FileEntry(name="") for _ in range(num_files)]
    empty_stream: list[bool] = [False] * num_files
    empty_file: list[bool] = []
    while True:
        t = r.number()
        if t == K_END:
            break
        size = r.number()
        end = r.pos + size
        if t == K_EMPTY_STREAM:
            empty_stream = r.bit_vector(num_files)
        elif t == K_EMPTY_FILE:
            n_empty = sum(empty_stream)
            empty_file = r.bit_vector(n_empty)
        elif t == K_NAME:
            external = r.byte()
            if external:
                raise UnsupportedError("external names")
            raw = r.bytes_(end - r.pos)
            names = raw.decode("utf-16-le").split("\0")
            if names and names[-1] == "":
                names.pop()
            if len(names) != num_files:
                raise ArchiveError("name count mismatch")
            for f, nm in zip(files, names):
                f.name = nm
        elif t == K_MTIME:
            defined = r.bool_vector(num_files)
            external = r.byte()
            if external:
                raise UnsupportedError("external times")
            for f, d in zip(files, defined):
                if d:
                    f.mtime = int.from_bytes(r.bytes_(8), "little")
        elif t == K_WIN_ATTRIB:
            defined = r.bool_vector(num_files)
            external = r.byte()
            if external:
                raise UnsupportedError("external attribs")
            for f, d in zip(files, defined):
                if d:
                    f.attrib = int.from_bytes(r.bytes_(4), "little")
        r.pos = end
    # map files onto folder substreams
    ei = 0
    fi = 0
    si = 0
    sub_iter = []
    for folder_idx in range(len(ar.folders)):
        for k in range(ar.num_unpack_streams[folder_idx]):
            sub_iter.append((folder_idx, k))
    sub_pos = 0
    offsets: dict[int, int] = {}
    for idx, f in enumerate(files):
        if empty_stream[idx]:
            f.has_stream = False
            is_empty = empty_file[ei] if ei < len(empty_file) else False
            ei += 1
            f.is_dir = not is_empty
            f.is_empty_file = is_empty
            f.size = 0
        else:
            if sub_pos >= len(sub_iter):
                raise ArchiveError("more file streams than substreams")
            folder_idx, k = sub_iter[sub_pos]
            sub_pos += 1
            f.folder = folder_idx
            f.size = ar.sub_sizes[folder_idx][k]
            f.crc = ar.sub_crcs[folder_idx][k] if ar.sub_crcs else None
            f.offset_in_folder = offsets.get(folder_idx, 0)
            offsets[folder_idx] = f.offset_in_folder + f.size
    ar.files = files


def parse(data: bytes) -> Archive:
    """Open a .7z image: start header, (possibly encoded) metadata header."""
    if data[:6] != SIGNATURE:
        raise NoArchiveError("no 7z signature")
    if len(data) < 32:
        raise InputEofError("7z too short")
    start_crc = int.from_bytes(data[8:12], "little")
    if crc32(data[12:32]) != start_crc:
        raise CrcError("start header CRC")
    nh_off = int.from_bytes(data[12:20], "little")
    nh_size = int.from_bytes(data[20:28], "little")
    nh_crc = int.from_bytes(data[28:32], "little")
    hdr = data[32 + nh_off:32 + nh_off + nh_size]
    if len(hdr) != nh_size:
        raise InputEofError("next header truncated")
    if crc32(hdr) != nh_crc:
        raise CrcError("next header CRC")
    ar = Archive()
    if not hdr:
        return ar
    r = _Reader(hdr)
    t = r.number()
    if t == K_ENCODED_HEADER:
        # metadata itself is a packed-streams section: decode it via the
        # same folder machinery (7zIn.c:1147-1212)
        (pack_pos, pack_sizes, folders, _nu, _ss, _sc) = _read_streams_info(r)
        if len(folders) != 1:
            raise ArchiveError("encoded header must have one folder")
        tmp = Archive(pack_pos=pack_pos, pack_sizes=pack_sizes,
                      folders=folders)
        tmp.folder_pack_base = [0]
        decoded = decode_folder(data, tmp, 0)
        if folders[0].crc is not None and crc32(decoded) != folders[0].crc:
            raise CrcError("encoded header content CRC")
        r = _Reader(decoded)
        t = r.number()
    if t != K_HEADER:
        raise ArchiveError(f"unexpected root property {t:#x}")
    _read_header(r, ar)
    return ar


# ---------------------------------------------------------------------------
# folder decoding (7zDec.c:335-470 semantics)
# ---------------------------------------------------------------------------

def _coder_out_index(folder: Folder, ci: int) -> int:
    return sum(c.num_out for c in folder.coders[:ci])


def _coder_in_index(folder: Folder, ci: int) -> int:
    return sum(c.num_in for c in folder.coders[:ci])


def decode_folder(data: bytes, ar: Archive, fi: int, *,
                  engine: str = "auto") -> bytes:
    """Decode one folder's full output in memory."""
    check_engine(engine, "7z")
    folder = ar.folders[fi]
    base_off = ar.folder_pack_offset(fi)
    base_idx = ar.folder_pack_base[fi]
    pack_offs = []
    off = base_off
    for k in range(len(folder.packed_indices)):
        pack_offs.append(off)
        off += ar.pack_sizes[base_idx + k]

    def packed_stream(k: int) -> bytes:
        return data[pack_offs[k]:pack_offs[k] + ar.pack_sizes[base_idx + k]]

    # evaluate coder outputs lazily with memoization over out-stream index
    out_cache: dict[int, bytes] = {}

    def in_stream(global_in: int) -> bytes:
        bp = folder.find_bind_pair_for_in(global_in)
        if bp >= 0:
            return out_stream(folder.bind_pairs[bp][1])
        k = folder.packed_indices.index(global_in)
        return packed_stream(k)

    def out_stream(global_out: int) -> bytes:
        if global_out in out_cache:
            return out_cache[global_out]
        # find the coder owning this out stream
        ci = 0
        while _coder_out_index(folder, ci) + folder.coders[ci].num_out <= global_out:
            ci += 1
        coder = folder.coders[ci]
        in_base = _coder_in_index(folder, ci)
        ins = [in_stream(in_base + j) for j in range(coder.num_in)]
        out_size = folder.unpack_sizes[global_out]
        res = _run_coder(coder, ins, out_size, engine)
        out_cache[global_out] = res
        return res

    for o in range(folder.num_out_total - 1, -1, -1):
        if folder.find_bind_pair_for_out(o) < 0:
            return out_stream(o)
    raise DataError("folder has no final output")


def _run_coder(coder: Coder, ins: list[bytes], out_size: int,
               engine: str) -> bytes:
    m = coder.method
    if m == M_COPY:
        if len(ins[0]) < out_size:
            raise DataError("copy coder input too short")
        return ins[0][:out_size]
    if m == M_LZMA:
        props = LzmaProps.from_bytes(coder.props)
        return lzma_raw_decode(ins[0], props, out_size, engine=engine)
    if m == M_LZMA2:
        if len(coder.props) != 1:
            raise DataError("bad LZMA2 props")
        out = framing.decode(ins[0], coder.props[0], engine=engine)
        if len(out) != out_size:
            raise DataError("LZMA2 folder size mismatch")
        return out
    if m == M_PPMD:
        # the native codec, always built: the JAX package's
        # LZT_PPMD_MAX_BYTES gate guards only its pure-Python fallback
        # (about 50 KB/s), which the port does not have
        return ppmd.decode(ins[0], coder.props, out_size)
    if m == M_BCJ:
        return FLT.x86_convert(ins[0][:out_size], 0, False)[0]
    if m in _BRANCH and _BRANCH[m] is not None:
        return _BRANCH[m](ins[0][:out_size], 0, False)
    if m == M_DELTA:
        if len(coder.props) != 1:
            raise DataError("bad delta props")
        return FLT.delta_decode(ins[0][:out_size], coder.props[0] + 1)[0]
    if m == M_BCJ2:
        if len(ins) != 4:
            raise DataError("BCJ2 needs 4 inputs")
        return FLT.bcj2_decode(ins[0], ins[1], ins[2], ins[3], out_size)
    raise UnsupportedError(f"7z method {m:#x}")


# ---------------------------------------------------------------------------
# extraction API (7zMain.c command equivalents)
# ---------------------------------------------------------------------------

def extract(data: bytes, *, verify: bool = True,
            engine: str = "auto") -> dict[str, bytes]:
    """Extract all files to memory (solid-block cache per folder)."""
    check_engine(engine, "7z")
    ar = parse(data)
    out: dict[str, bytes] = {}
    cache: dict[int, bytes] = {}
    for f in ar.files:
        if f.is_dir:
            continue
        if not f.has_stream:
            out[f.name] = b""
            continue
        if f.folder not in cache:
            body = decode_folder(data, ar, f.folder, engine=engine)
            folder = ar.folders[f.folder]
            if verify and folder.crc is not None and crc32(body) != folder.crc:
                raise CrcError(f"folder {f.folder} CRC mismatch")
            cache[f.folder] = body
        body = cache[f.folder]
        blob = body[f.offset_in_folder:f.offset_in_folder + f.size]
        if verify and f.crc is not None and crc32(blob) != f.crc:
            raise CrcError(f"file {f.name} CRC mismatch")
        out[f.name] = blob
    return out


def test(data: bytes, *, engine: str = "auto") -> list[str]:
    """The `t` command: decode + verify everything, return file names."""
    return list(extract(data, verify=True, engine=engine).keys())


def list_files(data: bytes) -> list[FileEntry]:
    return parse(data).files


# ---------------------------------------------------------------------------
# writer (capability beyond the reference)
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def byte(self, b: int):
        self.buf.append(b)

    def bytes_(self, b: bytes):
        self.buf += b

    def number(self, v: int):
        """Inverse of _Reader.number: n top-set flag bits select n extra
        little-endian low bytes; remaining first-byte bits carry the high
        part."""
        for n in range(9):
            if n == 8 or v < (1 << (8 * n + 7 - n)):
                mask = (0xFF00 >> n) & 0xFF
                high = (v >> (8 * n)) if n < 8 else 0
                self.buf.append(mask | high)
                self.buf += (v & ((1 << (8 * n)) - 1)).to_bytes(n, "little")
                return


def _write_number_bytes(v: int) -> bytes:
    w = _Writer()
    w.number(v)
    return bytes(w.buf)


def write(files: dict[str, bytes], *, method: int = M_LZMA2,
          dict_size: int = 1 << 20, solid: bool = True,
          pre_filter: int | None = None, encode_header: bool = False,
          effort: int = 9, engine: str = "auto",
          mtimes: dict[str, int] | None = None) -> bytes:
    """Build a .7z archive. ``solid`` packs all files into one folder;
    ``encode_header`` LZMA-compresses the metadata header (the
    kEncodedHeader form real 7z archives use); ``mtimes`` maps names to
    NTFS FILETIME ticks for the kMTime vector."""
    check_engine(engine, "7z")
    names = list(files.keys())
    blobs = [files[n] for n in names]

    groups: list[list[int]]
    if solid:
        groups = [[i for i in range(len(names)) if len(blobs[i]) > 0]]
        if not groups[0]:
            groups = []
    else:
        groups = [[i] for i in range(len(names)) if len(blobs[i]) > 0]

    def _codec_encode(payload: bytes) -> tuple[bytes, tuple[int, bytes]]:
        if method == M_COPY:
            return payload, (M_COPY, b"")
        if method == M_LZMA:
            props = LzmaProps(dict_size=dict_size)
            return (lzma_raw_encode(payload, props, effort=effort,
                                    engine=engine),
                    (M_LZMA, props.to_bytes()))
        if method == M_LZMA2:
            stream, prop = framing.encode(payload, dict_size=dict_size,
                                          effort=effort, engine=engine)
            return stream, (M_LZMA2, bytes([prop]))
        if method == M_PPMD:
            order = 6
            mem = max(1 << 20, min(dict_size, 1 << 28))
            stream, props = ppmd.encode(payload, order, mem)
            return stream, (M_PPMD, props)
        raise UnsupportedError(f"writer method {method:#x}")

    pack_streams: list[bytes] = []
    folders_meta = []
    for g in groups:
        body = b"".join(blobs[i] for i in g)
        if pre_filter == M_BCJ2:
            # the rigid 4-coder shape real 7z archives use
            # (CheckSupportedFolder, 7zDec.c:303-320): coder0=jump codec,
            # coder1=call codec, coder2=main codec, coder3=BCJ2;
            # bind pairs (5,0)(4,1)(3,2); pack indices [2,6,1,0]
            main, call, jump, rc = FLT.bcj2_encode(body)
            s_main, c_main = _codec_encode(main)
            s_call, c_call = _codec_encode(call)
            s_jump, c_jump = _codec_encode(jump)
            folders_meta.append((g, body, None, None, {
                "bcj2": True,
                "coders": [c_jump, c_call, c_main, (M_BCJ2, b"")],
                "out_sizes": [len(jump), len(call), len(main), len(body)],
                "streams": [s_main, rc, s_call, s_jump],  # pack idx 2,6,1,0
            }))
            pack_streams += [s_main, rc, s_call, s_jump]
            continue
        payload = body
        if pre_filter == M_BCJ:
            payload = FLT.x86_convert(body, 0, True)[0]
        elif pre_filter == M_DELTA:
            payload, _ = FLT.delta_encode(body, 1)
        stream, coder = _codec_encode(payload)
        folders_meta.append((g, body, payload, stream, [coder]))
        pack_streams.append(stream)

    out = bytearray()
    out += SIGNATURE + bytes([0, 4])
    out += bytes(24)  # start-header placeholder (crc + 20 bytes)
    pack_area_start = len(out)
    for s in pack_streams:
        out += s

    # ---- build header property tree ----
    w = _Writer()
    w.byte(K_HEADER)
    if groups:
        w.byte(K_MAIN_STREAMS)
        # PackInfo
        w.byte(K_PACK_INFO)
        w.number(0)
        w.number(len(pack_streams))
        w.byte(K_SIZE)
        for s in pack_streams:
            w.number(len(s))
        w.byte(K_END)
        # UnpackInfo
        w.byte(K_UNPACK_INFO)
        w.byte(K_FOLDER)
        w.number(len(folders_meta))
        w.byte(0)  # not external
        def _emit_coder(mid: int, props: bytes, num_in: int = 1):
            idb = mid.to_bytes(max(1, (mid.bit_length() + 7) // 8), "big")
            flag = len(idb) | (0x20 if props else 0) | (0x10 if num_in != 1 else 0)
            w.byte(flag)
            w.bytes_(idb)
            if num_in != 1:
                w.number(num_in)
                w.number(1)
            if props:
                w.number(len(props))
                w.bytes_(props)

        for g, body, payload, stream, coders in folders_meta:
            if isinstance(coders, dict):  # BCJ2 shape
                w.number(4)
                for k, (mid, props) in enumerate(coders["coders"]):
                    _emit_coder(mid, props, 4 if mid == M_BCJ2 else 1)
                for pair in ((5, 0), (4, 1), (3, 2)):
                    w.number(pair[0])
                    w.number(pair[1])
                for pi in (2, 6, 1, 0):
                    w.number(pi)
                continue
            chain = list(coders)
            if pre_filter == M_BCJ:
                chain = chain + [(M_BCJ, b"")]
            elif pre_filter == M_DELTA:
                chain = chain + [(M_DELTA, bytes([0]))]
            w.number(len(chain))
            for mid, props in chain:
                _emit_coder(mid, props)
            # decode-order chain [codec, filter]: filter input = codec output
            for k in range(len(chain) - 1):
                w.number(k + 1)
                w.number(k)
        w.byte(K_CODERS_UNPACK_SIZE)
        for g, body, payload, stream, coders in folders_meta:
            if isinstance(coders, dict):
                for sz in coders["out_sizes"]:
                    w.number(sz)
                continue
            w.number(len(payload))
            if pre_filter:
                w.number(len(body))
        w.byte(K_CRC)
        w.byte(1)  # all defined
        for g, body, payload, stream, coders in folders_meta:
            w.bytes_(crc32(body).to_bytes(4, "little"))
        w.byte(K_END)
        # SubStreamsInfo
        w.byte(K_SUBSTREAMS_INFO)
        w.byte(K_NUM_UNPACK_STREAM)
        for g, *_ in folders_meta:
            w.number(len(g))
        w.byte(K_SIZE)
        for g, body, *_ in folders_meta:
            for i in g[:-1]:
                w.number(len(blobs[i]))
        # substream CRCs are needed only where a folder holds > 1 stream
        # (single-stream folders are covered by the folder CRC)
        need_rows = [i for g, *_ in folders_meta if len(g) > 1 for i in g]
        if need_rows:
            w.byte(K_CRC)
            w.byte(1)  # all defined
            for i in need_rows:
                w.bytes_(crc32(blobs[i]).to_bytes(4, "little"))
        w.byte(K_END)
        w.byte(K_END)
    # FilesInfo
    w.byte(K_FILES_INFO)
    w.number(len(names))
    empty_mask = [len(b) == 0 for b in blobs]
    if any(empty_mask):
        bits = bytearray((len(names) + 7) // 8)
        for i, e in enumerate(empty_mask):
            if e:
                bits[i // 8] |= 0x80 >> (i % 8)
        w.byte(K_EMPTY_STREAM)
        w.number(len(bits))
        w.bytes_(bytes(bits))
        n_empty = sum(empty_mask)
        ebits = bytearray((n_empty + 7) // 8)
        for k in range(n_empty):
            ebits[k // 8] |= 0x80 >> (k % 8)  # all empties are empty FILES
        w.byte(K_EMPTY_FILE)
        w.number(len(ebits))
        w.bytes_(bytes(ebits))
    name_blob = b"".join((n + "\0").encode("utf-16-le") for n in names)
    w.byte(K_NAME)
    w.number(len(name_blob) + 1)
    w.byte(0)  # not external
    w.bytes_(name_blob)
    if mtimes:
        # kMTime vector: defined-bit vector + 8-byte FILETIMEs
        # (SzReadHeader2's MTime branch, 7zIn.c parity)
        defined = [n in mtimes for n in names]
        tbits = bytearray((len(names) + 7) // 8)
        for i, dfn in enumerate(defined):
            if dfn:
                tbits[i // 8] |= 0x80 >> (i % 8)
        blob = bytearray()
        if all(defined):
            blob.append(1)  # allDefined
        else:
            blob.append(0)
            blob += bytes(tbits)
        blob.append(0)      # not external
        for n_, dfn in zip(names, defined):
            if dfn:
                blob += int(mtimes[n_]).to_bytes(8, "little")
        w.byte(K_MTIME)
        w.number(len(blob))
        w.bytes_(bytes(blob))
    w.byte(K_END)
    w.byte(K_END)

    header = bytes(w.buf)

    if encode_header:
        # pack the metadata with LZMA and describe it as kEncodedHeader
        hprops = LzmaProps(dict_size=1 << 16)
        hstream = lzma_raw_encode(header, hprops, engine=engine)
        hpack_pos = len(out) - 32
        out += hstream
        w2 = _Writer()
        w2.byte(K_ENCODED_HEADER)
        w2.byte(K_PACK_INFO)
        w2.number(hpack_pos)
        w2.number(1)
        w2.byte(K_SIZE)
        w2.number(len(hstream))
        w2.byte(K_END)
        w2.byte(K_UNPACK_INFO)
        w2.byte(K_FOLDER)
        w2.number(1)
        w2.byte(0)
        w2.number(1)  # one coder
        idb = M_LZMA.to_bytes(3, "big")
        w2.byte(len(idb) | 0x20)
        w2.bytes_(idb)
        w2.number(len(hprops.to_bytes()))
        w2.bytes_(hprops.to_bytes())
        w2.byte(K_CODERS_UNPACK_SIZE)
        w2.number(len(header))
        w2.byte(K_CRC)
        w2.byte(1)
        w2.bytes_(crc32(header).to_bytes(4, "little"))
        w2.byte(K_END)
        w2.byte(K_END)
        header = bytes(w2.buf)

    nh_off = len(out) - 32
    out += header
    # start header
    sh = nh_off.to_bytes(8, "little") + len(header).to_bytes(8, "little") \
        + crc32(header).to_bytes(4, "little")
    out[12:32] = sh
    out[8:12] = crc32(sh).to_bytes(4, "little")
    return bytes(out)


# ---------------------------------------------------------------------------
# embedded-archive carving (the fork's LetsFind7z, My_Fucking_Main.cpp:21-70)
# ---------------------------------------------------------------------------

_FILETIME_EPOCH_DELTA = 11644473600  # seconds between 1601 and 1970


def filetime_to_unix(ticks: int) -> float:
    """NTFS FILETIME (100ns since 1601) → unix seconds (7zMain.c:223-259)."""
    return ticks / 10**7 - _FILETIME_EPOCH_DELTA


def apply_mtime(target: str, mtime: int | None) -> None:
    """Set a file's modification time from 7z MTime metadata (the
    reference sets times on extract, 7zMain.c:438-475)."""
    if not mtime:
        return
    t = filetime_to_unix(mtime)
    try:
        os.utime(target, times=(t, t))
    except OSError:
        pass  # unsupported filesystem: extraction still succeeds


def find_signature(data: bytes, start: int = 0) -> int:
    """Offset of the first 7z signature at/after ``start``, or -1."""
    return data.find(SIGNATURE, start)


def carve(data: bytes) -> bytes:
    """Extract the embedded .7z archive image from a host file."""
    off = find_signature(data)
    if off < 0:
        raise NoArchiveError("no embedded 7z signature found")
    sub = data[off:]
    # bound the image: start header gives next-header extent
    if len(sub) < 32:
        raise InputEofError("embedded archive truncated")
    nh_off = int.from_bytes(sub[12:20], "little")
    nh_size = int.from_bytes(sub[20:28], "little")
    end = 32 + nh_off + nh_size
    if end > len(sub):
        raise InputEofError("embedded archive truncated")
    return sub[:end]
