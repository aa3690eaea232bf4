"""Seeded small ``.7z`` archives laid out as 7-Zip writes them, for the
tests of the port's 7z device route (``containers/sevenzip.extract(
engine="device")``).

Each archive is ``sevenz_plain.archive`` of folders whose packed streams
the standard library's ``lzma`` makes: an LZMA2 folder is one dict-reset
group a part (each part encoded alone, end markers dropped, one end marker
after the last), and a BCJ folder runs the x86 filter over the whole
folder first, as 7-Zip does, then cuts the filtered bytes into the same
groups.  The header is LZMA-coded.  Nothing of the port makes a byte.
"""

from __future__ import annotations

import importlib.util
import lzma
import os
import random
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"lzt_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


plain = _load("sevenz_plain")
corpus = _load("corpus")

DICT = 1 << 16
DICT_PROP = 8                   # (2 | 0) << (8 // 2 + 11) = 64 KiB
HEADER = {"preset": 5, "dict_size": DICT, "nice_len": 273, "lc": 3,
          "lp": 0, "pb": 2}
LZMA2 = [{"id": lzma.FILTER_LZMA2, "preset": 5, "dict_size": DICT}]
LZMA1 = {"id": lzma.FILTER_LZMA1, "preset": 5, "dict_size": DICT, "lc": 3,
         "lp": 0, "pb": 2}
MTIME = 132223104000000000


def x86_encoded(data: bytes) -> bytes:
    """``data`` through liblzma's x86 BCJ encoder from state 0 at offset 0
    (an LZMA2 stream of the filtered bytes, read back without the
    filter)."""
    fast = [{"id": lzma.FILTER_LZMA2, "preset": 0}]
    return lzma.decompress(lzma.compress(data, lzma.FORMAT_RAW, filters=[
        {"id": lzma.FILTER_X86}] + fast), lzma.FORMAT_RAW, filters=fast)


def folder(parts: list, rng: random.Random, *, bcj: bool = False,
           lzma1: bool = False, stem: str = "data/part",
           exts: tuple = (".dat",), lo: int = 160, hi: int = 700) -> dict:
    """A folder (as ``sevenz_plain.header`` takes it) of ``parts``, one
    dict-reset group each (``lzma1``: one LZMA stream), cut into files by
    ``sevenz_plain.cut``."""
    body = b"".join(parts)
    coded = x86_encoded(body) if bcj else body
    if lzma1:
        out = {"packed": lzma.compress(coded, lzma.FORMAT_RAW,
                                       filters=[LZMA1]),
               "lzma_props": bytes([93]) + DICT.to_bytes(4, "little")}
    else:
        groups, at = [], 0
        for p in parts:
            groups.append(lzma.compress(coded[at:at + len(p)],
                                        lzma.FORMAT_RAW, filters=LZMA2)[:-1])
            at += len(p)
        out = {"packed": b"".join(groups) + b"\x00", "dict_prop": DICT_PROP}
    out.update(size=len(body), bcj=bcj,
               files=plain.cut(body, rng, lo, hi, stem, exts, 0x20, MTIME))
    return out


def archive(seed: int, *, exe: int = 1, data: int = 2, lzma1: int = 0,
            group: int = 1024, crc_fault: int | None = None) -> bytes:
    """An archive of up to three folders: ``exe`` groups of x86-like bytes
    behind BCJ (``.exe`` and ``.dll`` files), ``data`` groups of mixed
    bytes, and ``lzma1`` parts in an LZMA folder, each part ``group`` bytes
    or a little less.  ``crc_fault``: the file whose stored CRC32 is
    wrong."""
    rng = random.Random(seed)

    def sizes(n):
        return [group - rng.randrange(0, group // 4) for _ in range(n)]
    folders = []
    if exe:
        folders.append(folder([corpus.x86_like(n, seed + i) for i, n in
                               enumerate(sizes(exe))], rng, bcj=True,
                              stem="bin/app", exts=(".exe", ".dll")))
    if data:
        folders.append(folder([corpus.big_mixed(n, seed + 7 * i) for i, n in
                               enumerate(sizes(data))], rng))
    if lzma1:
        folders.append(folder([corpus.code_like(n, seed + 11 * i) for i, n
                               in enumerate(sizes(lzma1))], rng, lzma1=True,
                              stem="src/mod", exts=(".c",)))
    if crc_fault is not None:
        files = [f for fo in folders for f in fo["files"]]
        name, size, crc, mtime, attrib = files[crc_fault]
        for fo in folders:
            fo["files"] = [(name, size, crc ^ 1, mtime, attrib)
                           if f[0] == name else f for f in fo["files"]]
    return plain.archive(folders, HEADER)


def originals(img: bytes) -> dict:
    """The archive's files, as the plain reference reads them."""
    return plain.extract(img)
