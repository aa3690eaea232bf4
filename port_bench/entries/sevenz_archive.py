"""Entry point ``sevenz_archive``: each file a whole ``.7z`` archive as 7-Zip
writes it at ``-mx5``, extracted by ``containers.sevenzip.extract(image,
engine="device", device=...)`` with every CRC32 checked.

A file's image (``image``) holds two folders:

* folder 0, the executables: the file's first block (64 MiB in
  ``7z_mx5``) under x86 BCJ + LZMA2, coders ``[LZMA2, BCJ]`` bound ``(1,
  0)`` as ``7zDec.c`` reads them; its payload is liblzma's ``[FILTER_X86,
  FILTER_LZMA2]`` of the block's original (``prepare``, kept beside the
  pool's files as ``<block>.x86.lz2``), one dict-reset group;
* folder 1: the other blocks' pool payloads joined as one LZMA2 stream,
  one dict-reset group a block.

Each folder's bytes are cut into files (``sevenz_plain.cut``): sizes drawn
log-uniform between ``file_size_min`` and ``file_size_max`` from a seed the
image's blocks fix, the last file of a folder taking what is left; folder
0's files named ``.exe`` and ``.dll``, every file's attributes
``file_attributes``.  ``sevenz_plain.archive`` writes the image as 7-Zip's
``7zOut.cpp`` does (pack, unpack and substreams records, a CRC32 a file,
names, mtimes, attributes), the header LZMA-coded with the configuration's
``header`` parameters; the CRC32s come from ``zlib``.  Nothing of the port
computes any byte of an image, and ``sevenz_plain.extract`` reads every
image back to the pool's originals in the tests.

The port's output, a dict of files, reaches the comparison as ``Files``,
which joins them only when the comparison reads them, after the window.
The control decodes each folder with liblzma and joins the folders in
lane order, largest packed first (``Control``).
"""

from __future__ import annotations

import inspect
import json
import lzma
import random

from port_bench import lzma2_chunks, reference, sevenz_plain
from port_bench import pool as P
from port_bench.entries import lzma2_stream

CALL = "sevenzip.extract"
TIMED = ()

FILETIME_2020 = 132223104000000000      # 2020-01-01 00:00 UTC


def _port_route() -> None:
    """Stops the run at once, before the pool is built, where the port's
    ``sevenzip.extract`` has no device route (it takes no ``device``)."""
    from lzma_sdk_zliblike_tpu_torch.containers import sevenzip
    if "device" not in inspect.signature(sevenzip.extract).parameters:
        raise RuntimeError("the port's containers.sevenzip.extract has no "
                           "device route (engine='device', device=...)")


_port_route()


def _x86_path(pool, block) -> str:
    return pool.stem(block) + ".x86"


def x86_filters(config: dict) -> list:
    return [{"id": lzma.FILTER_X86}] + P.lzma2_filters(config)


def _stored_x86(pool, block) -> bytes | None:
    """``block``'s stored x86 + LZMA2 payload (with its end marker), or None
    where it is missing or made from another key or original."""
    meta = pool.record(block)
    stem = _x86_path(pool, block)
    try:
        with open(stem + ".json", "rb") as f:
            rec = json.load(f)
        with open(stem + ".lz2", "rb") as f:
            payload = f.read()
    except (OSError, ValueError):
        return None
    if meta is None or rec.get("key") != meta["key"] or \
            rec.get("raw_sha256") != meta["raw_sha256"] or \
            rec.get("lz2_sha256") != P._digest(payload):
        return None
    return payload


def _build_x86(pool, block) -> tuple:
    """Encodes and stores ``block``'s x86 + LZMA2 payload.  Returns
    ``block``."""
    raw = reference.block_original(pool, block)
    payload = lzma.compress(raw, lzma.FORMAT_RAW,
                            filters=x86_filters(pool.config))
    meta = pool.record(block)
    stem = _x86_path(pool, block)
    P._write(stem + ".lz2", payload)
    P._write(stem + ".json", json.dumps(
        {"key": meta["key"], "raw_sha256": meta["raw_sha256"],
         "lz2_sha256": P._digest(payload)}).encode())
    return block


def prepare(pool, blocks, workers: int | None = None) -> list:
    """Builds the x86 + LZMA2 payload of every full block of ``blocks``
    that has none stored (any full block may lead a file), on ``workers``
    processes.  Returns the blocks built."""
    todo = sorted(b for b in set(blocks) if b[1] == pool.config["block_size"]
                  and _stored_x86(pool, b) is None)
    P.build_all(_build_x86, [(pool, b) for b in todo], workers)
    return todo


def _folders(config: dict, blocks: list, x86: dict, plain: dict,
             raw: dict) -> list:
    """The two folders of a file of ``blocks``: ``x86`` and ``plain`` give
    each block's payload (end marker dropped) as it stands in folder 0 and
    folder 1, ``raw`` its bytes once decoded."""
    rng = random.Random(f"7z files {blocks}")
    prop = P.dict_prop(config["dict_size"])
    out = []
    for part, payloads, bcj, stem, exts in (
            (blocks[:1], x86, True, "bin/app", (".exe", ".dll")),
            (blocks[1:], plain, False, "data/part", (".dat",))):
        body = b"".join(raw[b] for b in part)
        out.append({"packed": P.join(payloads[b] for b in part),
                    "size": len(body), "bcj": bcj, "dict_prop": prop,
                    "files": sevenz_plain.cut(
                        body, rng, config["file_size_min"],
                        config["file_size_max"], stem, exts,
                        config["file_attributes"], FILETIME_2020)})
    return out


def images(pool, files, payloads) -> tuple[list, bytes]:
    """Each file's archive, and the warm-up archive: one of the same
    shape whose blocks are the first file's blocks cut to their first
    chunk, its files' bytes read back by liblzma."""
    config = pool.config
    x86 = {}
    for b in {f[0] for f in files}:
        stored = _stored_x86(pool, b)
        if stored is None:
            raise RuntimeError(f"block {b} has no stored x86 payload")
        x86[b] = stored[:-1]
    raw: dict = {}
    imgs = []
    for blocks in files:
        for b in blocks:
            if b not in raw:
                raw[b] = reference.block_original(pool, b)
        imgs.append(sevenz_plain.archive(
            _folders(config, blocks, x86, payloads, raw), config["header"]))
    raw.clear()
    first = {files[0][0]: lzma2_chunks.first_chunk(x86[files[0][0]])}
    firsts = {b: lzma2_chunks.first_chunk(payloads[b]) for b in files[0]}
    for b in files[0]:
        chain = x86_filters(config) if b in first else \
            P.lzma2_filters(config)
        raw[b] = lzma.decompress((first.get(b) or firsts[b]) + b"\x00",
                                 lzma.FORMAT_RAW, filters=chain)
    warm = sevenz_plain.archive(_folders(config, files[0], first, firsts,
                                         raw), config["header"])
    return imgs, warm


def lzma2_streams(img: bytes) -> list:
    """(offset, size) of each LZMA2 folder's packed stream."""
    ar = sevenz_plain.read(img)
    return [ar.packed_spans(fi)[0] for fi, f in enumerate(ar.folders)
            if f.coders[0].method == sevenz_plain.LZMA2]


def work(img: bytes) -> tuple[int, int]:
    packed = unpacked = 0
    for at, size in lzma2_streams(img):
        p, u = lzma2_chunks.work_bytes(img[at:at + size])
        packed, unpacked = packed + p, unpacked + u
    return packed, unpacked


class Files:
    """A call's files in archive order, as the comparison reads them: their
    bytes joined when first read (after the window), not in the call."""

    def __init__(self, files: dict):
        self.files = files
        self._joined: bytes | None = None

    def joined(self) -> bytes:
        if self._joined is None:
            self._joined = b"".join(self.files.values())
        return self._joined

    def __len__(self) -> int:
        return sum(len(v) for v in self.files.values())

    def __eq__(self, other) -> bool:
        return self.joined() == other

    def __buffer__(self, flags: int) -> memoryview:
        return memoryview(self.joined())


class Port(lzma2_stream.Port):
    """The system under test: the port's ``containers.sevenzip.extract``
    of a whole archive on the card, every CRC32 checked."""

    def __init__(self, config: dict, device: str):
        super().__init__(config, device)
        from lzma_sdk_zliblike_tpu_torch.containers import sevenzip
        from lzma_sdk_zliblike_tpu_torch.ops import device_filters
        self._7z, self._DF = sevenzip, device_filters

    def __call__(self, img: bytes) -> Files:
        return Files(self._7z.extract(img, engine="device",
                                      device=self.device))

    def reset_counters(self) -> None:
        super().reset_counters()
        self._DF.launches["x86"] = 0

    def counters(self) -> dict:
        snap = self._trace.snapshot()
        return dict(super().counters(), x86_launches=self._DF.launches["x86"],
                    host_folders=snap.get("sevenzip.host_folders", 0))


class Control:
    """The control: liblzma per folder (``sevenz_plain.decode_folder``),
    the folders joined in lane order, largest packed first; no CRC is
    read."""

    def __init__(self, config: dict):
        pass

    def __call__(self, img: bytes) -> bytes:
        ar = sevenz_plain.read(img)
        for f in ar.folders:
            f.crc = None
        outs = [sevenz_plain.decode_folder(img, ar, fi)
                for fi in range(len(ar.folders))]
        packed = [sum(s for _, s in ar.packed_spans(fi))
                  for fi in range(len(ar.folders))]
        return lzma2_stream.lane_order(outs, packed)
