"""The data generator of the block pool: a frozen copy of ``big_mixed`` and
the generators it draws on, from the repository's test corpus
(``tests/corpus.py``), so that an edit there cannot change what the
benchmark decodes.  Deterministic: the same seed gives the same bytes.

``big_mixed(n, seed)`` cycles through text, code, structured binary,
repetitive and x86-like pieces of 256,000 bytes, piece i drawn with seed
``seed + i``.
"""

from __future__ import annotations

import random
import struct


def english_like(n: int, seed: int = 1) -> bytes:
    rng = random.Random(seed)
    words = ("the quick brown fox jumps over lazy dog compression dictionary "
             "range coder probability context model state machine stream "
             "archive folder block chunk buffer window match distance literal "
             "encode decode parallel lane kernel mesh shard gather").split()
    out = []
    size = 0
    while size < n:
        w = rng.choice(words)
        if rng.random() < 0.1:
            w = w.capitalize()
        out.append(w)
        size += len(w) + 1
        if rng.random() < 0.08:
            out.append("\n")
    return (" ".join(out))[:n].encode()


def code_like(n: int, seed: int = 2) -> bytes:
    rng = random.Random(seed)
    lines = []
    size = 0
    idents = ["stream", "chunk", "probs", "state", "pos", "dist", "len_",
              "out", "src", "range_", "code"]
    while size < n:
        a, b = rng.choice(idents), rng.choice(idents)
        ln = f"    {a} = {b} + {rng.randint(0, 255)};  // update {a}\n"
        lines.append(ln)
        size += len(ln)
    return ("".join(lines))[:n].encode()


def binary_structured(n: int, seed: int = 3) -> bytes:
    rng = random.Random(seed)
    out = bytearray()
    while len(out) < n:
        out += struct.pack("<IHHq", rng.randint(0, 2**20), rng.randint(0, 500),
                           0xBEEF, rng.randint(-1000, 1000))
        out += bytes(8)
    return bytes(out[:n])


def repetitive(n: int, seed: int = 5) -> bytes:
    rng = random.Random(seed)
    pat = rng.randbytes(17) + b"ABCABCABC"
    out = (pat * (n // len(pat) + 1))[:n]
    return out


def x86_like(n: int, seed: int = 6) -> bytes:
    """Byte stream with embedded E8/E9 call/jmp rel32s (exercises BCJ)."""
    rng = random.Random(seed)
    out = bytearray()
    while len(out) < n:
        out += rng.randbytes(rng.randint(3, 12))
        op = rng.choice([0xE8, 0xE9])
        rel = rng.randint(-(1 << 20), 1 << 20)
        out += bytes([op]) + struct.pack("<i", rel)
    return bytes(out[:n])


def big_mixed(n: int, seed: int = 42) -> bytes:
    """Large deterministic mixed buffer for benchmarks."""
    rng = random.Random(seed)
    parts = []
    size = 0
    gens = [english_like, code_like, binary_structured, repetitive, x86_like]
    i = 0
    while size < n:
        g = gens[i % len(gens)]
        chunk = g(min(256_000, n - size), seed=seed + i)
        parts.append(chunk)
        size += len(chunk)
        i += 1
    return b"".join(parts)[:n]
