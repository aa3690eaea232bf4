"""Branch-converter filters (BCJ x86, BCJ2, ARM, ARMT, PPC, SPARC, IA64)
and the Delta filter, on the host: the port's copy of the JAX package's
``ops/filters.py``, which imports no JAX.

Semantics parity with the reference filter set (``Bra.h:56-63``,
``Bra86.c:11-85``, ``BraIA64.c:14-67``, ``Delta.c:20-62``, ``Bcj2.c``).
Implementations are from scratch and vectorized with numpy where the
transform allows (the fixed-alignment RISC filters are embarrassingly
parallel; x86 BCJ has a sequential mask heuristic so its hot scan is
numpy-assisted but position-sequential; BCJ2 decode is range-coded and
therefore scalar on the host — the batched device path treats it like any
other serial coder).

All converters share the reference signature: ``(data, ip, encoding) ->
bytes`` processing the whole buffer with stream offset ``ip``.
"""

from __future__ import annotations

import numpy as np

from ..utils.errors import DataError

_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# fixed-alignment RISC filters — fully vectorized
# ---------------------------------------------------------------------------

def arm_convert(data: bytes, ip: int = 0, encoding: bool = True) -> bytes:
    """ARM BL: word-aligned 4-byte insns ``xx xx xx EB`` (Bra.c:6-31)."""
    buf = bytearray(data)
    a = np.frombuffer(buf, np.uint8)
    n = (len(a) // 4) * 4
    if n == 0:
        return bytes(buf)
    w = a[:n].reshape(-1, 4)
    mask = w[:, 3] == 0xEB
    dest = (w[:, 2].astype(np.uint32) << 16) | (w[:, 1].astype(np.uint32) << 8) | w[:, 0]
    dest <<= 2
    pos = (np.arange(len(w), dtype=np.uint32) << 2) + np.uint32(ip + 8)
    conv = (dest + pos if encoding else dest - pos) & np.uint32(_MASK32)
    conv >>= 2
    w[mask, 0] = conv[mask] & 0xFF
    w[mask, 1] = (conv[mask] >> 8) & 0xFF
    w[mask, 2] = (conv[mask] >> 16) & 0xFF
    return bytes(buf)


def armt_convert(data: bytes, ip: int = 0, encoding: bool = True) -> bytes:
    """ARM Thumb BL pairs (xxF0 xxF8) at 2-byte alignment (Bra.c:33-67).

    The pair structure consumes 4 bytes on a hit, so the scan is position-
    sequential; candidate positions are pre-screened with numpy and the few
    hits are patched via the bytearray (python-int arithmetic — numpy uint8
    scalars would truncate the wide shifts)."""
    buf = bytearray(data)
    n = len(buf)
    if n < 4:
        return bytes(buf)
    a = np.frombuffer(buf, np.uint8)
    cand = (np.nonzero(((a[1:n - 2:2] & 0xF8) == 0xF0)
                       & ((a[3::2] & 0xF8) == 0xF8))[0] * 2).tolist()
    i = 0
    for c in cand:
        if c < i:
            continue
        # re-verify on the live buffer (a prior hit may have rewritten bytes)
        if (buf[c + 1] & 0xF8) != 0xF0 or (buf[c + 3] & 0xF8) != 0xF8:
            continue
        src = (((buf[c + 1] & 0x7) << 19) | (buf[c] << 11)
               | ((buf[c + 3] & 0x7) << 8) | buf[c + 2]) << 1
        pos = (ip + 4 + c) & _MASK32
        dest = ((pos + src) if encoding else (src - pos)) & _MASK32
        dest >>= 1
        buf[c + 1] = 0xF0 | ((dest >> 19) & 0x7)
        buf[c] = (dest >> 11) & 0xFF
        buf[c + 3] = 0xF8 | ((dest >> 8) & 0x7)
        buf[c + 2] = dest & 0xFF
        i = c + 4
    return bytes(buf)


def ppc_convert(data: bytes, ip: int = 0, encoding: bool = True) -> bytes:
    """PPC bl: BE words ``0x48xxxxx1`` (Bra.c:69-97)."""
    buf = bytearray(data)
    a = np.frombuffer(buf, np.uint8)
    n = (len(a) // 4) * 4
    if n == 0:
        return bytes(buf)
    w = a[:n].reshape(-1, 4)
    mask = ((w[:, 0] & 0xFC) == 0x48) & ((w[:, 3] & 0x3) == 1)
    dest = (((w[:, 0].astype(np.uint32) & 0x3) << 24)
            | (w[:, 1].astype(np.uint32) << 16)
            | (w[:, 2].astype(np.uint32) << 8)
            | (w[:, 3].astype(np.uint32) & 0xFC))
    pos = (np.arange(len(w), dtype=np.uint32) << 2) + np.uint32(ip)
    conv = (dest + pos if encoding else dest - pos) & np.uint32(_MASK32)
    w[mask, 0] = 0x48 | ((conv[mask] >> 24) & 0x3)
    w[mask, 1] = (conv[mask] >> 16) & 0xFF
    w[mask, 2] = (conv[mask] >> 8) & 0xFF
    w[mask, 3] = (conv[mask] & 0xFC) | (w[mask, 3] & 0x3)
    return bytes(buf)


def sparc_convert(data: bytes, ip: int = 0, encoding: bool = True) -> bytes:
    """SPARC call: BE words 0x40000000.. / 0x7FFFxxxx (Bra.c:99-133)."""
    buf = bytearray(data)
    a = np.frombuffer(buf, np.uint8)
    n = (len(a) // 4) * 4
    if n == 0:
        return bytes(buf)
    w = a[:n].reshape(-1, 4).astype(np.uint32)
    word = (w[:, 0] << 24) | (w[:, 1] << 16) | (w[:, 2] << 8) | w[:, 3]
    mask = ((w[:, 0] == 0x40) & ((w[:, 1] & 0xC0) == 0)) | \
           ((w[:, 0] == 0x7F) & ((w[:, 1] & 0xC0) == 0xC0))
    dest = word << 2
    pos = (np.arange(len(w), dtype=np.uint32) << 2) + np.uint32(ip)
    conv = (dest + pos if encoding else dest - pos) & np.uint32(_MASK32)
    conv >>= 2
    # Bra.c:124: dest = (((0 - ((dest >> 22) & 1)) << 22) & 0x3FFFFFFF)
    #                   | (dest & 0x3FFFFF) | 0x40000000
    conv = ((conv & 0x3FFFFF) | 0x40000000
            | np.where((conv & 0x400000) != 0, np.uint32(0x3FC00000), np.uint32(0)))
    out = np.where(mask, conv, word)
    res = a[:n].reshape(-1, 4)
    res[:, 0] = (out >> 24) & 0xFF
    res[:, 1] = (out >> 16) & 0xFF
    res[:, 2] = (out >> 8) & 0xFF
    res[:, 3] = out & 0xFF
    return bytes(buf)


def ia64_convert(data: bytes, ip: int = 0, encoding: bool = True) -> bytes:
    """IA64 brl in 16-byte bundles; slot rewrite per template
    (BraIA64.c:14-67)."""
    BR_TABLE = [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                4, 4, 6, 6, 0, 0, 7, 7, 4, 4, 0, 0, 4, 4, 0, 0]
    buf = bytearray(data)
    n = len(buf)
    for off in range(0, n - 15, 16):
        template = buf[off] & 0x1F
        mask = BR_TABLE[template]
        if mask == 0:
            continue
        for slot in range(3):
            if not ((mask >> slot) & 1):
                continue
            bit_pos = 5 + slot * 41
            byte_pos = bit_pos >> 3
            bit_res = bit_pos & 7
            instr = 0
            for j in range(6):
                instr |= buf[off + byte_pos + j] << (8 * j)
            inst_norm = instr >> bit_res
            # brl opcode: major op 5 with the 3 bits at 9..11 clear
            if ((inst_norm >> 37) & 0xF) != 0x5 or ((inst_norm >> 9) & 0x7) != 0:
                continue
            src = ((inst_norm >> 13) & 0xFFFFF) | (((inst_norm >> 36) & 1) << 20)
            src <<= 4
            pos = (ip + off) & _MASK32
            dest = ((pos + src) if encoding else (src - pos)) & _MASK32
            dest >>= 4
            inst_norm &= ~(0x8FFFFF << 13)
            inst_norm |= (dest & 0xFFFFF) << 13
            inst_norm |= (dest & 0x100000) << (36 - 20)
            instr &= (1 << bit_res) - 1
            instr |= inst_norm << bit_res
            for j in range(6):
                buf[off + byte_pos + j] = (instr >> (8 * j)) & 0xFF
    return bytes(buf)


# ---------------------------------------------------------------------------
# x86 BCJ — sequential mask heuristic (Bra86.c:11-85)
# ---------------------------------------------------------------------------

_TEST86 = lambda b: b == 0 or b == 0xFF


def x86_convert(data: bytes, ip: int = 0, encoding: bool = True,
                state: int = 0) -> tuple[bytes, int, int]:
    """E8/E9 call/jump rel32 ↔ abs conversion with the 3-bit prev-mask
    heuristic.  Returns ``(converted, mask_state, processed)``; streaming
    callers carry ``mask_state`` and re-feed the unprocessed tail (< 5
    bytes) with the next chunk (the fork's streaming BCJ keeps equivalent
    state, ``7zDec.c:506-527``)."""
    buf = bytearray(data)
    n = len(buf)
    if n < 5:
        return bytes(buf), state & 0x7, 0
    mask_to_allowed = [True, True, True, False, True, False, False, False]
    mask_to_bit = [0, 1, 2, 2, 3, 3, 3, 3]
    prev_mask = state & 0x7
    prev_pos = -1  # distance handling mirrors the reference loop
    i = 0
    while i < n - 4:
        b = buf[i]
        if b != 0xE8 and b != 0xE9:
            i += 1
            continue
        d = i - prev_pos
        prev_pos = i
        if d > 3:
            prev_mask = 0
        else:
            prev_mask = (prev_mask << (d - 1)) & 0x7
        if prev_mask != 0:
            bb = buf[i + 4 - mask_to_bit[prev_mask]]
            if not mask_to_allowed[prev_mask] or _TEST86(bb):
                prev_mask = ((prev_mask << 1) & 0x7) | 1
                i += 1
                continue
        if _TEST86(buf[i + 4]):
            src = int.from_bytes(buf[i + 1:i + 5], "little")
            while True:
                if encoding:
                    dest = (src + (ip + i + 5)) & _MASK32
                else:
                    dest = (src - (ip + i + 5)) & _MASK32
                if prev_mask == 0:
                    break
                idx = mask_to_bit[prev_mask] * 8
                bb = (dest >> (24 - idx)) & 0xFF
                if not _TEST86(bb):
                    break
                src = dest ^ ((1 << (32 - idx)) - 1)
            dest &= 0x01FFFFFF
            if dest & 0x01000000:
                dest |= 0xFE000000
            buf[i + 1:i + 5] = (dest & _MASK32).to_bytes(4, "little")
            i += 5
        else:
            prev_mask = ((prev_mask << 1) & 0x7) | 1
            i += 1
    d = i - prev_pos
    out_state = 0 if d > 3 else (prev_mask << (d - 1)) & 0x7
    return bytes(buf), out_state, i


# ---------------------------------------------------------------------------
# Delta filter (Delta.c:20-62)
# ---------------------------------------------------------------------------

def delta_encode(data: bytes, dist: int, state: bytes = b"") -> tuple[bytes, bytes]:
    """Byte-wise delta with distance 1..256; returns (out, carry_state)."""
    if not 1 <= dist <= 256:
        raise DataError(f"bad delta distance {dist}")
    a = np.frombuffer(data, np.uint8)
    hist = np.frombuffer(state.ljust(dist, b"\0"), np.uint8)[:dist] if state else np.zeros(dist, np.uint8)
    ext = np.concatenate([hist, a])
    out = (ext[dist:] - ext[:-dist]).astype(np.uint8)
    new_state = bytes(ext[-dist:]) if len(ext) >= dist else bytes(ext)
    return out.tobytes(), new_state


def delta_decode(data: bytes, dist: int, state: bytes = b"") -> tuple[bytes, bytes]:
    """Inverse of delta_encode (prefix-sum with period `dist`)."""
    if not 1 <= dist <= 256:
        raise DataError(f"bad delta distance {dist}")
    a = np.frombuffer(data, np.uint8).copy()
    n = len(a)
    hist = np.frombuffer(state.ljust(dist, b"\0"), np.uint8)[:dist].copy() if state else np.zeros(dist, np.uint8)
    # decode[i] = delta[i] + decode[i-dist]: cumulative sum per residue class
    for r in range(dist):
        lane = a[r::dist]
        if len(lane):
            a[r::dist] = (np.cumsum(lane.astype(np.uint64)) + hist[r]).astype(np.uint8)
    out = a.tobytes()
    full = bytes(hist) + out
    return out, full[-dist:]


def bcj2_encode(data: bytes, ip: int = 0) -> tuple[bytes, bytes, bytes, bytes]:
    """Produce the 4 BCJ2 streams (main, call, jump, rc) for ``data``.

    The reference SDK ships only the BCJ2 *decoder* (``Bcj2.c``); this
    encoder is ours, emitting streams its decoder (and ours) reconstructs
    bit-exactly.  Conversion heuristic: convert a site when the absolute
    target fits 32 bits with a 00/FF top byte pattern typical of real
    branches (any choice is valid; it only affects ratio).
    """
    main = bytearray()
    call = bytearray()
    jump = bytearray()
    probs = [1024] * (2 + 256)
    # carry-correct range encoder (same semantics as the LZMA one)
    low = 0
    rng = 0xFFFFFFFF
    cache = 0
    cache_size = 1
    rc = bytearray()

    def shift_low():
        nonlocal low, cache, cache_size
        if low < 0xFF000000 or low > _MASK32:
            carry = low >> 32
            rc.append((cache + carry) & 0xFF)
            if cache_size > 1:
                rc.extend(bytes([(0xFF + carry) & 0xFF]) * (cache_size - 1))
            cache = (low >> 24) & 0xFF
            cache_size = 0
        cache_size += 1
        low = (low & 0x00FFFFFF) << 8

    def encode_bit(i, bit):
        nonlocal low, rng
        p = probs[i]
        bound = (rng >> 11) * p
        if bit == 0:
            rng = bound
            probs[i] = p + ((2048 - p) >> 5)
        else:
            low += bound
            rng -= bound
            probs[i] = p - (p >> 5)
        while rng < (1 << 24):
            rng = (rng << 8) & _MASK32
            shift_low()

    n = len(data)
    i = 0
    prev = 0
    while i < n:
        b = data[i]
        main.append(b)
        i += 1
        is_site = ((b & 0xFE) == 0xE8 or (prev == 0x0F and (b & 0xF0) == 0x80))
        if not is_site or i + 4 > n:
            if is_site and i + 4 > n:
                # site too close to the end: decoder only reads a flag if
                # output remains, and always needs 4 rel bytes to convert —
                # emit flag 0 so the tail stays literal, unless the site
                # byte is the very last output byte (no flag read at all)
                if i < n:
                    pidx = (2 + prev) if b == 0xE8 else (0 if b == 0xE9 else 1)
                    encode_bit(pidx, 0)
            prev = b
            continue
        pidx = (2 + prev) if b == 0xE8 else (0 if b == 0xE9 else 1)
        rel = int.from_bytes(data[i:i + 4], "little")
        # the decoder reconstructs rel as stored - (outPos + 4); outPos == i
        # here, so absolute targets are relative to the stream start (the
        # 7z convention — ip is not part of the BCJ2 transform)
        dest = (rel + i + 4) & _MASK32
        top = data[i + 3]
        convert = top in (0x00, 0xFF)
        if convert:
            encode_bit(pidx, 1)
            tgt = call if b == 0xE8 else jump
            tgt += dest.to_bytes(4, "big")
            prev = (data[i + 3]) & 0xFF
            i += 4
        else:
            encode_bit(pidx, 0)
            prev = b
    # flush
    for _ in range(5):
        shift_low()
    return bytes(main), bytes(call), bytes(jump), bytes(rc)


# ---------------------------------------------------------------------------
# BCJ2 decode (Bcj2.c:28-127): 4-input-stream x86 transform
# ---------------------------------------------------------------------------

def bcj2_decode(main: bytes, call: bytes, jump: bytes, rc: bytes,
                out_size: int) -> bytes:
    """Merge main bytes + 4-byte BE targets selected by a range-coded
    adaptive flag per E8/E9/0F8x site."""
    probs = [1024] * (2 + 256)
    out = bytearray()
    # range decoder over rc stream
    if len(rc) < 5:
        raise DataError("bcj2 rc stream too short")
    code = int.from_bytes(rc[1:5], "big")
    rng = 0xFFFFFFFF
    rc_pos = 5

    def decode_bit(i: int) -> int:
        nonlocal code, rng, rc_pos
        if rng < (1 << 24):
            rng = (rng << 8) & _MASK32
            b = rc[rc_pos] if rc_pos < len(rc) else 0
            code = ((code << 8) | b) & _MASK32
            rc_pos += 1
        p = probs[i]
        bound = (rng >> 11) * p
        if code < bound:
            rng = bound
            probs[i] = p + ((2048 - p) >> 5)
            return 0
        rng -= bound
        code -= bound
        probs[i] = p - (p >> 5)
        return 1

    m_pos = c_pos = j_pos = 0
    prev = 0
    while len(out) < out_size:
        if m_pos >= len(main):
            raise DataError("bcj2 main stream exhausted")
        b = main[m_pos]
        m_pos += 1
        out.append(b)
        if len(out) == out_size:
            break
        is_j = False
        if (b & 0xFE) == 0xE8 or (prev == 0x0F and (b & 0xF0) == 0x80):
            if b == 0xE8:
                pidx = 2 + prev
            elif b == 0xE9:
                pidx = 0
            else:
                pidx = 1
            if decode_bit(pidx):
                src = call if b == 0xE8 else jump
                pos = c_pos if b == 0xE8 else j_pos
                if pos + 4 > len(src):
                    raise DataError("bcj2 target stream exhausted")
                dest = int.from_bytes(src[pos:pos + 4], "big")
                if b == 0xE8:
                    c_pos += 4
                else:
                    j_pos += 4
                rel = (dest - (len(out) + 4)) & _MASK32
                out += rel.to_bytes(4, "little")
                prev = (rel >> 24) & 0xFF
                continue
        prev = b
    return bytes(out)
