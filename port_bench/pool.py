"""The block pool of a configuration: fixed blocks, each made from its own
generator seed and encoded once by liblzma, cached on disk.

A block is ``(index, size)``: block ``(i, n)`` of a configuration is
``corpus.big_mixed(n, seed)`` with ``seed = generator_seed_base + i *
generator_seed_step`` (``traffic.files`` gives the full blocks the
configuration's ``block_size`` and each short last block an index of its
own), encoded
alone by Python's ``lzma`` (liblzma, the library ``xz`` uses) as a raw
LZMA2 stream (``FORMAT_RAW``, ``FILTER_LZMA2`` at the configuration's
preset).  So each block starts with a dictionary reset, exactly as an
``xz`` block payload does.  Its end marker is dropped: ``join`` puts one
end marker after the last block, and the stream is one LZMA2 stream of
dict-reset groups.

The cache holds, per block, ``<i>.lz2`` (the payload), ``<i>.raw`` (the
original bytes) and ``<i>.json`` (the key and both files' sizes and
SHA-256).  The key hashes the generator's source and every parameter the
block depends on; a block whose key, size or hash does not match is built
again.  Nothing here imports the port.
"""

from __future__ import annotations

import concurrent.futures
import functools
import hashlib
import json
import lzma
import multiprocessing
import os

from . import corpus

FORMAT = 2       # bump when the layout of the cache changes
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")

# The configuration's keys a block depends on.
BLOCK_KEYS = ("generator", "generator_seed_base", "generator_seed_step",
              "preset", "dict_size", "lc", "lp", "pb")


@functools.cache
def _generator_hash() -> str:
    with open(corpus.__file__, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def block_key(config: dict, block: tuple) -> str:
    """Hash of everything ``block`` of ``config`` is made from."""
    doc = {k: config[k] for k in BLOCK_KEYS}
    doc.update(index=block[0], size=block[1], format=FORMAT,
               corpus=_generator_hash())
    return hashlib.sha256(json.dumps(doc, sort_keys=True).encode()).hexdigest()


def block_seed(config: dict, index: int) -> int:
    return config["generator_seed_base"] + index * config["generator_seed_step"]


def original(config: dict, block: tuple) -> bytes:
    """``block``'s original bytes, made by the frozen generator."""
    if config["generator"] != "big_mixed":
        raise ValueError(f"unknown generator {config['generator']!r}")
    return corpus.big_mixed(block[1], block_seed(config, block[0]))


def lzma2_filters(config: dict) -> list:
    return [{"id": lzma.FILTER_LZMA2, "preset": config["preset"],
             "dict_size": config["dict_size"], "lc": config["lc"],
             "lp": config["lp"], "pb": config["pb"]}]


def encode(config: dict, data: bytes) -> bytes:
    """``data`` as one raw LZMA2 block payload (liblzma), without its end
    marker."""
    c = lzma.compress(data, format=lzma.FORMAT_RAW,
                      filters=lzma2_filters(config))
    if c[-1:] != b"\x00":
        raise RuntimeError("liblzma's LZMA2 stream does not end with its "
                           "end marker")
    return c[:-1]


def join(payloads) -> bytes:
    """Block payloads as one LZMA2 stream: each block's end marker is
    already dropped, so one end marker follows the last."""
    return b"".join(payloads) + b"\x00"


def dict_prop(dict_size: int) -> int:
    """The LZMA2 dictionary property byte of ``dict_size`` (the smallest
    property whose size covers it)."""
    for p in range(40):
        if (2 | (p & 1)) << (p // 2 + 11) >= dict_size:
            return p
    return 40


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _write(path: str, data: bytes) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _build_block(config: dict, block: tuple, folder: str) -> tuple:
    """Makes, encodes and stores ``block``.  Returns ``block``."""
    raw = original(config, block)
    payload = encode(config, raw)
    stem = os.path.join(folder, f"{block[0]:05d}")
    _write(stem + ".raw", raw)
    _write(stem + ".lz2", payload)
    meta = {"key": block_key(config, block), "raw_size": len(raw),
            "raw_sha256": _digest(raw), "lz2_size": len(payload),
            "lz2_sha256": _digest(payload)}
    _write(stem + ".json", json.dumps(meta, sort_keys=True).encode())
    return block


def build_all(fn, jobs: list, workers: int | None = None) -> None:
    """Runs ``fn(*job)`` for each of ``jobs`` on ``workers`` processes
    (None: one a core; 1: in this process) and waits for every one."""
    if workers is None:
        workers = len(os.sched_getaffinity(0))
    workers = max(1, min(workers, len(jobs)))
    if workers == 1:
        for job in jobs:
            fn(*job)
        return
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers,
                                                mp_context=ctx) as ex:
        for fut in [ex.submit(fn, *job) for job in jobs]:
            fut.result()


class Pool:
    """The cached blocks of one configuration under ``cache_dir``."""

    def __init__(self, config: dict, cache_dir: str = CACHE_DIR):
        self.config = config
        self.folder = os.path.join(cache_dir, config["name"])

    def stem(self, block: tuple) -> str:
        return os.path.join(self.folder, f"{block[0]:05d}")

    def record(self, block: tuple) -> dict | None:
        """The block's stored record, or None where it is missing, of
        another key, or its files are not of the recorded sizes."""
        stem = self.stem(block)
        try:
            with open(stem + ".json", "rb") as f:
                meta = json.load(f)
            sizes = (os.path.getsize(stem + ".raw"),
                     os.path.getsize(stem + ".lz2"))
        except (OSError, ValueError):
            return None
        if meta.get("key") != block_key(self.config, block) or \
                sizes != (meta.get("raw_size"), meta.get("lz2_size")):
            return None
        return meta

    def ensure(self, blocks, workers: int | None = None) -> list[tuple]:
        """Builds every one of ``blocks`` whose record is stale, on
        ``workers`` processes (None: one a core; 1: in this process).
        Returns the blocks built."""
        todo = sorted({b for b in blocks if self.record(b) is None})
        if not todo:
            return []
        os.makedirs(self.folder, exist_ok=True)
        build_all(_build_block, [(self.config, b, self.folder) for b in todo],
                  workers)
        return todo

    def payload(self, block: tuple) -> bytes:
        """``block``'s LZMA2 payload, checked against its record; built
        again where the record or the hash does not match."""
        for _ in range(2):
            meta = self.record(block)
            if meta is not None:
                with open(self.stem(block) + ".lz2", "rb") as f:
                    data = f.read()
                if _digest(data) == meta["lz2_sha256"]:
                    return data
            os.makedirs(self.folder, exist_ok=True)
            _build_block(self.config, block, self.folder)
        raise RuntimeError(f"block {block} of {self.config['name']} does not "
                           "match its record after a rebuild")
