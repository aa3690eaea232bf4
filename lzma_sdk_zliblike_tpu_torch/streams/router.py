"""Folder-output → file routing for streaming extraction.

The fork routes decoded solid-folder bytes straight into the correct output
files by tracking cumulative per-file offsets, opening/closing files as the
stream crosses their boundaries (``CountBytesToWrite``/``WriteStream``,
``7zStream.c:217-303``).  Same idea here, as a small class: the port's
copy of the JAX package's ``streams/router.py``.
"""

from __future__ import annotations

import os

from ..utils.checksums import crc32
from ..utils.errors import CrcError


class FileRouter:
    """Write a folder's decoded byte stream into its member files."""

    def __init__(self, entries: list[tuple[str, int, int | None]],
                 out_dir: str, *, verify: bool = True):
        """entries: (relative name, size, crc or None) in folder order."""
        self.entries = entries
        self.out_dir = out_dir
        self.verify = verify
        self._idx = 0
        self._written = 0
        self._crc = 0
        self._fh = None

    def _open_next(self):
        name, _size, _crc = self.entries[self._idx]
        path = os.path.join(self.out_dir, name)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "wb")
        self._written = 0
        self._crc = 0

    def write(self, data: bytes) -> None:
        pos = 0
        while pos < len(data):
            if self._idx >= len(self.entries):
                raise ValueError("folder stream longer than its files")
            name, size, want_crc = self.entries[self._idx]
            if self._fh is None:
                self._open_next()
            take = min(len(data) - pos, size - self._written)
            chunk = data[pos:pos + take]
            self._fh.write(chunk)
            if self.verify:
                self._crc = crc32(chunk, self._crc)
            self._written += take
            pos += take
            if self._written == size:
                self._fh.close()
                self._fh = None
                if self.verify and want_crc is not None and self._crc != want_crc:
                    raise CrcError(f"file {name} CRC mismatch (streaming)")
                self._idx += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._idx != len(self.entries):
            raise ValueError("folder stream ended before all files written")
