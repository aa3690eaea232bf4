"""Peaks of the card, and the least time a kernel's work could take.

NVIDIA H100 SXM (data sheet, at the full 700 W power limit): 80 GB of HBM3
at 3.35 TB/s.  The table is the yardstick's; the port's own copy of the
rate (``chip_smoke.HBM_BYTES_PER_S``) is not read.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def decode_bytes_bound_s(packed: int, unpacked: int) -> float:
    """Least seconds for a decode on the card: the packed bytes read once
    and the output bytes written once at the HBM rate (the arithmetic of
    ``chip_smoke.bound_ms``).  LZMA's real limit is each lane's serial
    chain of range-coder bit calls, far above this bound."""
    return (packed + unpacked) / HBM_BYTES_PER_S
