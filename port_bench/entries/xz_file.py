"""Entry point ``xz_file``: each file a whole ``.xz`` image, as ``xz -T0``
writes it, decoded by ``containers.xz.decode(image, engine="device",
device=...)`` with ``verify`` at its default, so every block's check is
computed and compared: the path ``xz_util d`` takes.

A file's image (``image``) is one ``.xz`` stream:

* the stream header: magic, flags ``00 <check id>``, their CRC32;
* per block, its header with both sizes (flags 0xC0: one filter, the
  compressed and the uncompressed size), the LZMA2 filter (0x21) with its
  dictionary property byte, zero padding to the size liblzma's threaded
  encoder reserves for a header of the configuration's block size, and the
  header's CRC32; the block's LZMA2 payload with its end marker; zero
  padding to 4 bytes; the block's check of its original bytes;
* the index, one record (unpadded size, uncompressed size) per block,
  padded to 4 bytes, and its CRC32; the stream footer.

The header CRC32s come from ``zlib.crc32``.  Each block's check comes
from liblzma: the block's original encoded by Python's ``lzma`` as an
``.xz`` stream with the configuration's check and filters, its check field
read back (``liblzma_block``); that stream's payload has to equal the
pool's, end marker added, or the build stops.  The checks are kept beside
the pool's files, ``<block>.check.json``, with the block's key and its
original's SHA-256.  Nothing of the port computes any byte of an image.

The control decodes each block's payload with liblzma and joins the
blocks in lane order, largest packed first (``Control``).
"""

from __future__ import annotations

import json
import lzma
import zlib

from port_bench import lzma2_chunks, reference
from port_bench import pool as P
from port_bench.entries import lzma2_stream

CALL = "xz.decode"
_XZ = "lzma_sdk_zliblike_tpu_torch.containers.xz"
TIMED = ((_XZ, "lzma2_uncompress", "xz_block.lzma2_uncompress", "inner"),
         (_XZ, "_check_compute", "xz_check._check_compute", "check"))

MAGIC = b"\xfd7zXZ\x00"
FOOTER_MAGIC = b"YZ"
FILTER_LZMA2 = 0x21
# check name -> (check id, size, liblzma's constant)
CHECKS = {"crc64": (0x04, 8, lzma.CHECK_CRC64)}


def _crc32(data: bytes) -> bytes:
    return zlib.crc32(data).to_bytes(4, "little")


def varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def read_varint(data: bytes, pos: int) -> tuple[int, int]:
    v = shift = 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, pos


def stream_header(check_id: int) -> bytes:
    flags = bytes([0, check_id])
    return MAGIC + flags + _crc32(flags)


def buffer_bound(size: int) -> int:
    """liblzma's ``lzma_block_buffer_bound64``: the most bytes a block of
    ``size`` bytes encodes to, with its headers."""
    lzma2 = size + -(-size // (1 << 16)) * 3 + 1
    return 92 + -(-lzma2 // 4) * 4


def block_header(comp: int, uncomp: int, dict_prop: int,
                 block_size: int) -> bytes:
    """A block header with both sizes, as liblzma's threaded encoder
    writes it: in the room it reserved for a block of ``block_size``
    (``stream_encoder_mt.c``), so a short block's header is padded to a
    full one's."""
    def fields(c, u):
        return bytes([0xC0]) + varint(c) + varint(u) + bytes(
            [FILTER_LZMA2, 1, dict_prop])
    room = len(fields(buffer_bound(block_size), block_size))
    size = -(-(1 + room + 4) // 4) * 4
    head = bytes([size // 4 - 1]) + fields(comp, uncomp)
    head += bytes(size - 4 - len(head))
    return head + _crc32(head)


def index(records) -> bytes:
    out = bytearray(b"\x00") + varint(len(records))
    for unpadded, uncomp in records:
        out += varint(unpadded) + varint(uncomp)
    out += bytes(-len(out) % 4)
    return bytes(out) + _crc32(bytes(out))


def stream_footer(index_size: int, check_id: int) -> bytes:
    tail = (index_size // 4 - 1).to_bytes(4, "little") + bytes([0, check_id])
    return _crc32(tail) + tail + FOOTER_MAGIC


def image(blocks, payloads: dict, checks: dict, config: dict) -> bytes:
    """The ``.xz`` image of a file of ``blocks``: ``payloads`` (without end
    markers) and ``checks`` by block."""
    check_id = CHECKS[config["check"]][0]
    prop = P.dict_prop(config["dict_size"])
    parts, records = [stream_header(check_id)], []
    for b in blocks:
        body = payloads[b] + b"\x00"
        head = block_header(len(body), b[1], prop, config["block_size"])
        parts += [head, body, bytes(-len(body) % 4), checks[b]]
        records.append((len(head) + len(body) + len(checks[b]), b[1]))
    idx = index(records)
    parts += [idx, stream_footer(len(idx), check_id)]
    return b"".join(parts)


def blocks_of(img: bytes):
    """(payload start, payload end with its end marker) of each block of a
    one-stream image whose block headers hold both sizes."""
    check_size = {v[0]: v[1] for v in CHECKS.values()}[img[7]]
    pos, out = 12, []
    while img[pos]:
        head = (img[pos] + 1) * 4
        comp, _ = read_varint(img, pos + 2)
        start = pos + head
        out.append((start, start + comp))
        pos = start + comp + (-comp % 4) + check_size
    return out


def work(img: bytes) -> tuple[int, int]:
    packed = unpacked = 0
    for a, b in blocks_of(img):
        p, u = lzma2_chunks.work_bytes(img[a:b])
        packed, unpacked = packed + p, unpacked + u
    return packed, unpacked


def liblzma_block(config: dict, raw: bytes, check: str) -> tuple:
    """(payload with its end marker, check) of ``raw`` encoded by liblzma
    as a one-block ``.xz`` stream with ``check`` and the configuration's
    LZMA2 filter."""
    _, size, lib_check = CHECKS[check]
    x = lzma.compress(raw, format=lzma.FORMAT_XZ, check=lib_check,
                      filters=P.lzma2_filters(config))
    ipos = len(x) - 12 - (int.from_bytes(x[-8:-4], "little") + 1) * 4
    unpadded, _ = read_varint(x, ipos + 2)     # the one record's first size
    head = (x[12] + 1) * 4
    comp = unpadded - head - size
    start = 12 + head
    end = start + comp + (-comp % 4)
    return x[start:start + comp], x[end:end + size]


def _record_path(pool, block) -> str:
    return pool.stem(block) + ".check.json"


def _stored(pool, block, check: str) -> bytes | None:
    """The block's stored check, or None where it is missing or of another
    key, original or check."""
    meta = pool.record(block)
    try:
        with open(_record_path(pool, block), "rb") as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    if meta is None or rec.get("check") != check or \
            rec.get("key") != meta["key"] or \
            rec.get("raw_sha256") != meta["raw_sha256"]:
        return None
    return bytes.fromhex(rec["value"])


def _build_check(pool, block) -> tuple:
    """Computes and stores ``block``'s check.  Returns ``block``."""
    check = pool.config["check"]
    raw = reference.block_original(pool, block)
    payload, value = liblzma_block(pool.config, raw, check)
    if payload != pool.payload(block) + b"\x00":
        raise RuntimeError(f"block {block}: liblzma's .xz payload is not the "
                           "pool's")
    meta = pool.record(block)
    rec = {"key": meta["key"], "raw_sha256": meta["raw_sha256"],
           "check": check, "value": value.hex()}
    P._write(_record_path(pool, block), json.dumps(rec).encode())
    return block


def prepare(pool, blocks, workers: int | None = None) -> list:
    """Builds the check of every one of ``blocks`` that has none stored, on
    ``workers`` processes (``pool.build_all``).  Returns the blocks built."""
    check = pool.config["check"]
    todo = sorted(b for b in set(blocks) if _stored(pool, b, check) is None)
    P.build_all(_build_check, [(pool, b) for b in todo], workers)
    return todo


def images(pool, files, payloads) -> tuple[list, bytes]:
    """Each file's image, and the warm-up image: one block of each size the
    first file holds (the block shapes the window decodes).  The checks
    are those ``prepare`` stored."""
    checks = {}
    for b in {b for f in files for b in f}:
        checks[b] = _stored(pool, b, pool.config["check"])
        if checks[b] is None:
            raise RuntimeError(f"block {b} has no stored check")
    imgs = [image(f, payloads, checks, pool.config) for f in files]
    first: dict = {}
    for b in files[0]:
        first.setdefault(b[1], b)
    return imgs, image(list(first.values()), payloads, checks, pool.config)


class Port(lzma2_stream.Port):
    """The system under test: the port's ``containers.xz.decode`` of a whole
    image on K1, every block's check verified."""

    def __init__(self, config: dict, device: str):
        super().__init__(config, device)
        from lzma_sdk_zliblike_tpu_torch.containers import xz
        self._xz = xz

    def __call__(self, img: bytes) -> bytes:
        return self._xz.decode(img, engine="device", device=self.device)


class Control:
    """The control: liblzma per block payload, the blocks joined in lane
    order (the ordered join left out); no check is read."""

    def __init__(self, config: dict):
        self.filters = [{"id": lzma.FILTER_LZMA2,
                         "dict_size": config["dict_size"]}]

    def __call__(self, img: bytes) -> bytes:
        spans = blocks_of(img)
        outs = [lzma.decompress(img[a:b], lzma.FORMAT_RAW,
                                filters=self.filters) for a, b in spans]
        return lzma2_stream.lane_order(outs, [b - a for a, b in spans])
