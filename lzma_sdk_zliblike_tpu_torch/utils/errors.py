"""Error model.

The reference propagates integer ``SRes`` codes through every call
(``Types.h:25-43`` + the ``RINOK`` macro, ``Types.h:51-53``).  This package
uses an exception hierarchy instead; each class keeps its ``SRes`` code,
as the JAX package's ``utils/errors.py`` does, so that the CLIs exit with
the reference's codes.
"""

from __future__ import annotations


class LzmaError(Exception):
    """Base for all framework errors. Mirrors nonzero SRes (Types.h:25-43)."""

    sres: int = 11  # SZ_ERROR_FAIL

    def __init__(self, msg: str = ""):
        super().__init__(msg or self.__class__.__name__)


class DataError(LzmaError):
    """Corrupt stream (SZ_ERROR_DATA = 1)."""

    sres = 1


class MemError(LzmaError):
    """Allocation failure (SZ_ERROR_MEM = 2)."""

    sres = 2


class CrcError(LzmaError):
    """Integrity-check mismatch (SZ_ERROR_CRC = 3)."""

    sres = 3


class UnsupportedError(LzmaError):
    """Unsupported method, option or device (SZ_ERROR_UNSUPPORTED = 4)."""

    sres = 4


class ParamError(LzmaError):
    """Invalid parameter (SZ_ERROR_PARAM = 5)."""

    sres = 5


class InputEofError(LzmaError):
    """Input ended mid-stream (SZ_ERROR_INPUT_EOF = 6)."""

    sres = 6


class OutputEofError(LzmaError):
    """Output buffer too small (SZ_ERROR_OUTPUT_EOF = 7)."""

    sres = 7


class ReadError(LzmaError):
    """Stream read failure (SZ_ERROR_READ = 8)."""

    sres = 8


class WriteError(LzmaError):
    """Stream write failure (SZ_ERROR_WRITE = 9)."""

    sres = 9


class ProgressAborted(LzmaError):
    """A progress callback asked to stop (SZ_ERROR_PROGRESS = 10)."""

    sres = 10


class ThreadError(LzmaError):
    """Scheduler/executor failure (SZ_ERROR_THREAD = 12)."""

    sres = 12


class ArchiveError(LzmaError):
    """Malformed archive metadata (SZ_ERROR_ARCHIVE = 16)."""

    sres = 16


class NoArchiveError(LzmaError):
    """No archive signature found (SZ_ERROR_NO_ARCHIVE = 17)."""

    sres = 17


_SRES_MAP = {cls.sres: cls for cls in (
    DataError, MemError, CrcError, UnsupportedError, ParamError,
    InputEofError, OutputEofError, ReadError, WriteError, ProgressAborted,
    ThreadError, ArchiveError, NoArchiveError)}


def raise_for_sres(code: int, msg: str = "") -> None:
    """Raise the exception matching a native-layer SRes code (0 = no-op)."""
    if code == 0:
        return
    raise _SRES_MAP.get(code, LzmaError)(msg or f"SRes={code}")
