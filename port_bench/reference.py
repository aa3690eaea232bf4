"""The plain reference of a decode and the comparison that decides
``correct``.

The reference's answer for a file is its blocks' original bytes, made by
the frozen generator (``corpus.big_mixed``) and joined in the file's order.
It imports nothing of the port and takes nothing the port made: the
originals are read from the pool's cache where their SHA-256 matches the
record written when the generator made them, and made again otherwise.

The comparison is exact.  ``wrong_bytes`` counts, over the calls compared,
the bytes of an output that differ from the reference's, plus the
difference of their lengths; its limit is 0.
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import pool as P


def block_original(pool: P.Pool, block: tuple) -> bytes:
    """``block``'s original bytes, as the frozen generator makes them."""
    meta = pool.record(block)
    if meta is not None:
        with open(pool.stem(block) + ".raw", "rb") as f:
            data = f.read()
        if hashlib.sha256(data).hexdigest() == meta["raw_sha256"]:
            return data
    return P.original(pool.config, block)


def expected(pool: P.Pool, blocks: list[tuple], cache: dict) -> bytes:
    """The reference's output for a file of ``blocks`` (``cache`` keeps the
    originals read so far, by block)."""
    for b in blocks:
        if b not in cache:
            cache[b] = block_original(pool, b)
    return b"".join(cache[b] for b in blocks)


def wrong_bytes(output: bytes, reference: bytes) -> int:
    """Bytes of ``output`` that differ from ``reference``, plus the
    difference of their lengths."""
    if output == reference:
        return 0
    n = min(len(output), len(reference))
    a = np.frombuffer(output, np.uint8, n)
    b = np.frombuffer(reference, np.uint8, n)
    return int(np.count_nonzero(a != b)) + abs(len(output) - len(reference))
