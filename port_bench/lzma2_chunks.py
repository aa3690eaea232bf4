"""LZMA2 chunk headers, read by the benchmark itself (not by the port), for
the work a file holds (K1's bytes bound) and for the warm-up file.

A chunk starts with its control byte: 0x00 ends the stream; 0x01 / 0x02 an
uncompressed chunk with / without a dictionary reset, then its size less 1
(16 bits, big-endian); 0x80-0xFF an LZMA chunk whose bits 5-6 are its
reset mode (3: dictionary reset) and bits 0-4 the top of its unpacked size
less 1, then the rest of that size (16 bits), its packed size less 1 (16
bits) and, from reset mode 2 on, a properties byte.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Chunk:
    start: int        # offset of the control byte
    end: int          # offset just past the body
    packed: int       # body bytes
    unpacked: int
    dict_reset: bool


def chunks(stream: bytes) -> list[Chunk]:
    """Every chunk of a raw LZMA2 stream up to its end marker."""
    out, pos = [], 0
    while True:
        if pos >= len(stream):
            raise ValueError("LZMA2 stream has no end marker")
        c = stream[pos]
        if c == 0x00:
            return out
        if c in (0x01, 0x02):
            size = int.from_bytes(stream[pos + 1:pos + 3], "big") + 1
            head, packed, unpacked, reset = 3, size, size, c == 0x01
        elif c >= 0x80:
            unpacked = ((c & 0x1F) << 16) + int.from_bytes(
                stream[pos + 1:pos + 3], "big") + 1
            packed = int.from_bytes(stream[pos + 3:pos + 5], "big") + 1
            head = 6 if (c >> 5) & 3 >= 2 else 5
            reset = (c >> 5) & 3 == 3
        else:
            raise ValueError(f"bad LZMA2 control byte {c:#04x} at {pos}")
        end = pos + head + packed
        if end > len(stream):
            raise ValueError(f"LZMA2 chunk at {pos} runs past the stream")
        out.append(Chunk(pos, end, packed, unpacked, reset))
        pos = end


def work_bytes(stream: bytes) -> tuple[int, int]:
    """(packed, unpacked) bytes of the stream's chunks: what a decoder has
    to read once and write once."""
    cs = chunks(stream)
    return sum(c.packed for c in cs), sum(c.unpacked for c in cs)


def first_chunk(payload: bytes) -> bytes:
    """A block payload cut to its first chunk (which resets the dictionary
    and the coder state): a short block of the same kind, without its end
    marker."""
    cs = chunks(payload + b"\x00")
    if not cs or not cs[0].dict_reset:
        raise ValueError("block payload does not start with a dictionary "
                         "reset")
    return payload[:cs[0].end]
