"""Error model.

The reference propagates integer ``SRes`` codes through every call
(``Types.h:25-43`` + the ``RINOK`` macro, ``Types.h:51-53``).  This package
uses an exception hierarchy instead; each class keeps its ``SRes`` code.
Only the classes the port raises are defined here.
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


class ProgressAborted(LzmaError):
    """A progress callback asked to stop (SZ_ERROR_PROGRESS = 10)."""

    sres = 10


class ArchiveError(LzmaError):
    """Malformed archive metadata (SZ_ERROR_ARCHIVE = 16)."""

    sres = 16


_SRES_MAP = {cls.sres: cls for cls in (DataError, CrcError, UnsupportedError,
                                       ParamError, InputEofError,
                                       OutputEofError, ProgressAborted,
                                       ArchiveError)}


def raise_for_sres(code: int, msg: str = "") -> None:
    """Raise the exception matching a native-layer SRes code (0 = no-op)."""
    if code == 0:
        return
    raise _SRES_MAP.get(code, LzmaError)(msg or f"SRes={code}")
