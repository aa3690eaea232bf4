"""Integrity checks: CRC32, CRC64, SHA-256.

The port's copy of the JAX package's ``utils/checksums.py``.  Parity
targets: the reference's reflected CRC32 poly 0xEDB88320 (``7zCrc.c:9-18``;
identical to zlib, so ``binascii.crc32`` is bit-exact), the xz CRC64 poly
0xC96C5795D7870F42 (``XzCrc64.c:6-33``), and SHA-256 (``Sha256.c``;
``hashlib`` is bit-exact).  CRC64 runs in the port's native runtime
(``native.crc64``, slicing-by-8), which is always built; there is no
slower fallback.  The polynomials are defined here once; the device CRCs
(``ops/checksum.py``) take them from this module.
"""

from __future__ import annotations

import binascii
import hashlib

from .. import native

CRC32_POLY = 0xEDB88320            # reflected (7zCrc.c:9)
CRC64_POLY = 0xC96C5795D7870F42    # reflected ECMA-182 (XzCrc64.c:6)


def crc32(data: bytes | bytearray | memoryview, value: int = 0) -> int:
    """One-shot / rolling CRC32 (reference ``CrcCalc``/``CrcUpdate``)."""
    return binascii.crc32(data, value) & 0xFFFFFFFF


def crc64(data: bytes | bytearray | memoryview, value: int = 0) -> int:
    """One-shot / rolling CRC64 (reference ``Crc64Calc``/``Crc64Update``)."""
    return native.crc64(data, value)


def sha256(data: bytes) -> bytes:
    """SHA-256 digest (reference ``Sha256_*``).

    Computed by ``hashlib``, where the JAX package calls its owned native
    SHA-256 when the runtime is built.  The digests are the same bytes;
    ``hashlib`` is the faster of the two on a host, so the port keeps it
    and binds the owned implementation as ``native.sha256`` /
    ``native.Sha256`` only."""
    return hashlib.sha256(data).digest()


class Sha256Stream:
    """Incremental SHA-256 matching the reference's Init/Update/Final.

    On ``hashlib``, as the JAX package's is; ``native.Sha256`` is the
    owned implementation and the slower of the two (see ``sha256``)."""

    def __init__(self):
        self._h = hashlib.sha256()

    def update(self, data) -> None:
        self._h.update(data)

    def digest(self) -> bytes:
        return self._h.digest()


class Crc32Stream:
    def __init__(self):
        self.value = 0

    def update(self, data) -> None:
        self.value = crc32(data, self.value)


class Crc64Stream:
    def __init__(self):
        self.value = 0

    def update(self, data) -> None:
        self.value = crc64(data, self.value)
