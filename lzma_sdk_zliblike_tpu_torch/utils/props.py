"""Encoder property normalization (CLzmaEncProps / CLzma2EncProps analog).

The reference layers two props structs with ``-1 = default`` fields and a
``Normalize()`` that derives everything from ``level``
(``LzmaEncProps_Normalize``, ``LzmaEnc.c:53-74``;
``Lzma2EncProps_Normalize``, ``Lzma2Enc.c:176-221``).  This is the same
surface for this package (the port's copy of the JAX package's
``utils/props.py``): fill what you know, ``normalize()`` resolves the
rest, including the thread factorization (total = lzma × block threads) and
the LZMA2 block size rule (4 × dict, clamped [1 MB, 256 MB]).
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class EncProps:
    """LZMA/LZMA2 encode properties; -1/None = derive from level."""

    level: int = 5
    dict_size: int = 0          # 0 = from level (LzmaLib.h:44-52 table)
    lc: int = -1                # -1 -> 3
    lp: int = -1                # -1 -> 0
    pb: int = -1                # -1 -> 2
    algo: int = -1              # 0 fast parse, 1 BT4+optimal; -1 = level>=5
    fb: int = -1                # nice_len: level<7 -> 32/64 semantics
    bt_mode: int = -1           # finder: 0 hash-chain, 1 binary tree
    mc: int = -1                # finder cutoff (mc=32 default for BT)
    # LZMA2 / MtCoder layer
    chunk_size: int = 0         # dict-reset group bytes; 0 = 4x dict clamped
    num_block_threads: int = -1
    num_total_threads: int = -1

    def normalize(self) -> "EncProps":
        p = dataclasses.replace(self)
        level = p.level if p.level >= 0 else 5
        if level > 9:
            level = 9
        p.level = level
        if p.dict_size == 0:
            table = {0: 1 << 14, 1: 1 << 16, 2: 1 << 18, 3: 1 << 20,
                     4: 1 << 22, 5: 1 << 24, 6: 1 << 25}
            p.dict_size = table.get(level, 1 << 26)
        if p.lc < 0:
            p.lc = 3
        if p.lp < 0:
            p.lp = 0
        if p.pb < 0:
            p.pb = 2
        if p.algo < 0:
            p.algo = 1 if level >= 5 else 0
        if p.fb < 0:
            p.fb = 32 if level < 7 else 64
        if p.bt_mode < 0:
            p.bt_mode = p.algo
        if p.mc < 0:
            p.mc = (16 + (p.fb >> 1)) >> (0 if p.bt_mode else 1)
        # LZMA2 block size: 4 x dict clamped [1MB, 256MB] (Lzma2Enc.c:223-233)
        if p.chunk_size == 0:
            blk = 4 * p.dict_size
            blk = max(1 << 20, min(blk, 1 << 28))
            # the native group encoder caps groups at 2MB (packed tables);
            # larger requested blocks stream as consecutive 2MB groups
            p.chunk_size = min(blk, 1 << 21)
        # thread factorization t_total = t_lzma(1) x t_block (Lzma2Enc.c:176)
        ncpu = os.cpu_count() or 1
        if p.num_total_threads < 0:
            p.num_total_threads = (p.num_block_threads
                                   if p.num_block_threads > 0 else ncpu)
        if p.num_block_threads < 0:
            p.num_block_threads = max(1, p.num_total_threads)
        return p

    @property
    def effort(self) -> int:
        """Map (algo, fb, mc) onto the engine's effort knob."""
        if self.algo <= 0:
            return 9 if self.fb < 0 or self.fb >= 32 else 7
        return 11 if (self.fb >= 64 or self.mc > 48) else 10


def from_level(level: int, **overrides) -> EncProps:
    return dataclasses.replace(EncProps(level=level), **overrides).normalize()
