"""Input batches of the port's X4 filter checks (``ops/device_filters.py``).

``tests/test_torch_device_filters.py`` and ``chip_smoke.py`` hold the
filters on the same batches: the salted lanes and BCJ2 corpus of the JAX
package's ``tests/test_device_filters.py``, rebuilt here without JAX.  Both
load this module by path (a foreign package named ``tests`` may shadow this
directory).
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np


def _corpus():
    spec = importlib.util.spec_from_file_location(
        "lzt_corpus", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "corpus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


random_bytes = _corpus().random_bytes


def salted_batch(seed, S=5, L=4096):
    """The salted batch (``_mk_batch``): every converter's opcodes, x86
    clusters for the prev-mask heuristic, lanes of full, short, 8-byte and
    empty ``valid``.  Returns (data [S, L] uint8, valid int32, ip uint32)."""
    rng = np.random.default_rng(seed)
    data = np.frombuffer(random_bytes(S * L, seed=seed), np.uint8).reshape(
        S, L).copy()
    for s in range(S):
        for _ in range(40):
            off = int(rng.integers(0, L - 4)) & ~3
            data[s, off + 3] = 0xEB            # ARM BL
            off = int(rng.integers(0, L - 4)) & ~3
            data[s, off] = 0x48                # PPC bl
            data[s, off + 3] |= 1
            off = int(rng.integers(0, L - 4)) & ~3
            data[s, off] = 0x40                # SPARC call
            data[s, off + 1] &= 0x3F
            off = int(rng.integers(0, L - 4)) & ~1
            data[s, off + 1] = 0xF0 | (data[s, off + 1] & 7)   # ARMT BL pair
            data[s, off + 3] = 0xF8 | (data[s, off + 3] & 7)
            off = int(rng.integers(0, (L - 16) // 16)) * 16    # IA64 brl
            data[s, off] = 0x16
            data[s, off + 1] &= 0x3F
            data[s, off + 2] &= 0xFE
            data[s, off + 5] = (data[s, off + 5] & 0xC3) | 0x14
            off = int(rng.integers(0, L - 12))
            data[s, off] = 0xE8
            data[s, off + 4] = 0x00            # plain convertible call
            off = int(rng.integers(0, L - 12))
            data[s, off] = 0xE9
            data[s, off + 4] = 0xFF            # convertible jump
            off = int(rng.integers(0, L - 14))
            data[s, off] = 0xE8                # candidates 2 apart
            data[s, off + 2] = 0xE8
            data[s, off + 6] = 0xFF
            off = int(rng.integers(0, L - 14))
            data[s, off] = 0xE8                # dense run
            data[s, off + 1] = 0xE8
            data[s, off + 2] = 0xE8
            data[s, off + 5] = 0x00
            data[s, off + 6] = 0x00
    valid = np.array([L, L - 4, L - 128, 8, 0][:S], np.int32)
    ip = np.array([0, 4096, 12345 & ~3, 0, 0][:S], np.uint32)
    return data, valid, ip


# the lanes' valid lengths of the negative-valid batch: the five converters
# compare with valid as uint32, so -1 and -4096 cover the whole row
NEGATIVE_VALID = (-1, -4096, 2 ** 31 - 1, 8, 0)


def negative_valid_batch():
    """The salted batch of seed 3 with ``valid`` = ``NEGATIVE_VALID``."""
    data, _, ip = salted_batch(3)
    return data, np.array(NEGATIVE_VALID, np.int32), ip


def _ia64_brl_bundles(row: np.ndarray) -> None:
    """Every 16-byte bundle of ``row`` (in place) gets template ``(k + 23)
    % 32`` (bundle k: every template in 32 bundles, a slot mask of 7 in the
    32nd) and a brl opcode in all three slots: instruction bits 37-40 of a
    slot 5, bits 9-11 0."""
    for k in range(len(row) // 16):
        b = int.from_bytes(row[16 * k:16 * k + 16].tobytes(), "little")
        b = (b & ~0x1F) | ((k + 23) % 32)
        for slot in range(3):
            at = 5 + 41 * slot
            b &= ~(0x7 << (at + 9)) & ~(0xF << (at + 37))
            b |= 0x5 << (at + 37)
        row[16 * k:16 * k + 16] = np.frombuffer(b.to_bytes(16, "little"),
                                                np.uint8)


# the edge batches' row lengths: 16-aligned, and rows that take the kernels'
# byte path (not a multiple of 16; odd for Thumb; L % 16 of 1 and 15 for
# IA64)
BRANCH_EDGE_LENGTHS = {"arm": (512, 516), "ppc": (512, 516),
                       "sparc": (512, 516), "armt": (512, 514, 513),
                       "ia64": (512, 513, 527)}


def branch_edge_batch(name: str, L: int):
    """Lanes of ``L`` bytes whose every unit holds a site of converter
    ``name`` (arm, armt, ppc, sparc or ia64): ARM words ending in 0xEB,
    PPC ``bl`` words, SPARC calls of both signs, Thumb pairs at 4-aligned
    halfwords (at 2 mod 4 in odd lanes), IA64 bundles of every template
    with a brl in each slot.  Lanes 0-6 have ``valid`` -1, 0, 3, 4, 5, L and
    L + 100 at ip 0; lanes 7 and 8 valid L at ip 2^32 - 4 and 2^32 - 16,
    where positions wrap.  Returns (data [9, L] uint8, valid int32, ip
    uint32)."""
    rng = np.random.default_rng(sum(map(ord, name)) * 1000 + L)
    data = rng.integers(0, 256, (9, L), dtype=np.uint8)
    W = L // 4 * 4
    words = data[:, :W].reshape(9, W // 4, 4)     # a view: writes land in data
    if name == "arm":
        words[..., 3] = 0xEB
    elif name == "ppc":
        words[..., 0] = 0x48 | (words[..., 0] & 3)
        words[..., 3] = (words[..., 3] & 0xFC) | 1
    elif name == "sparc":
        neg = rng.integers(0, 2, words.shape[:2]).astype(bool)
        words[..., 0] = np.where(neg, 0x7F, 0x40)
        words[..., 1] = np.where(neg, words[..., 1] | 0xC0,
                                 words[..., 1] & 0x3F)
    elif name == "armt":
        for s in range(9):
            at = 2 * (s % 2)
            data[s, at + 1:L:4] = 0xF0 | (data[s, at + 1:L:4] & 7)
            data[s, at + 3:L:4] = 0xF8 | (data[s, at + 3:L:4] & 7)
    elif name == "ia64":
        for s in range(9):
            _ia64_brl_bundles(data[s])
    else:
        raise ValueError(name)
    valid = np.array([-1, 0, 3, 4, 5, L, L + 100, L, L], np.int32)
    ip = np.array([0] * 7 + [2 ** 32 - 4, 2 ** 32 - 16], np.uint32)
    return data, valid, ip


def delta_rows(L: int, seed: int):
    """Seven lanes of ``L`` random bytes for delta, with ``valid`` L, L - 7,
    13, 0, -1, L + 100 and L // 2 + 3 (inside a middle segment of long rows).
    Returns (data [7, L] uint8, valid int32)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (7, L), dtype=np.uint8)
    valid = np.array([L, L - 7, 13, 0, -1, L + 100, L // 2 + 3], np.int32)
    return data, valid


def x86_edge_batch():
    """x86 lanes the salted batch misses: valid 0-6 around the 5-byte
    minimum, a dense E8/E9 run with 00/FF operands (the Bra86.c:58-67
    retry), and an ip near 2^32 so positions wrap."""
    L = 256
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (9, L), dtype=np.uint8)
    data[:7, :8] = [0xE8, 0, 0, 0, 0, 0xE8, 0xFF, 0xFF]
    data[7, ::3] = 0xE8
    data[7, 1::3] = 0xFF
    data[8, ::5] = 0xE9
    data[8, 4::5] = 0x00
    valid = np.array([0, 1, 4, 5, 6, 7, L, L, L], np.int32)
    ip = np.array([0] * 7 + [0xFFFFFFF0, 0xFFFFFFFE], np.uint32)
    return data, valid, ip


def x86_past_row_batch():
    """x86 lanes whose ``valid`` passes the row: the JAX function clamps
    every index to the row's last byte and steps at most L times.  Rows end
    on 00 or FF, so sites near the end convert on clamped reads, and once
    no site is left the scan stays at L; row 3 ends on E8, where the scan
    stays."""
    L = 64
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (8, L), dtype=np.uint8)
    data[:, ::7] = 0xE8
    data[:, L - 1] = [0, 0xFF] * 4
    data[1, L - 2] = 0xE8
    data[6, L - 2] = 0xE9
    data[2, L - 6:] = [0xE9, 0, 0, 0, 0, 0]
    data[3, L - 3:] = [0xE8, 0xFF, 0xE8]
    data[4, L - 8:] = [0xE8, 0xE8, 0, 0, 0xFF, 0xFF, 0xE9, 0]
    valid = np.array([L + 1, L + 4, L + 5, L + 6, L + 9, 2 * L, L + 100,
                      1 << 30], np.int32)
    ip = np.array([0, 16, 0xFFFFFFF8, 3, 0, 7, 1 << 31, 12], np.uint32)
    return data, valid, ip


def bcj2_corpus() -> list[bytes]:
    """The BCJ2 corpus: four lanes of 8-9.5 KiB of random bytes salted with
    convertible call, jump and Jcc sites."""
    rng = np.random.default_rng(11)
    datas = []
    for s in range(4):
        d = bytearray(random_bytes(8192 + 512 * s, seed=100 + s))
        for _ in range(60):
            off = int(rng.integers(0, len(d) - 8))
            kind = int(rng.integers(0, 3))
            if kind == 0:
                d[off] = 0xE8
            elif kind == 1:
                d[off] = 0xE9
            else:
                d[off] = 0x0F
                d[off + 1] = 0x80 | int(rng.integers(0, 16))
            d[off + 5] = 0x00 if rng.integers(0, 2) else 0xFF
        datas.append(bytes(d))
    return datas


def pad_rows(bufs) -> tuple[np.ndarray, np.ndarray]:
    """Byte strings as the rows of a zero-padded [n, w] uint8 array (w the
    longest rounded up to 4, at least 8) and their lengths (int32)."""
    w = max(8, -(-max(len(b) for b in bufs) // 4) * 4)
    arr = np.zeros((len(bufs), w), np.uint8)
    for i, b in enumerate(bufs):
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
    return arr, np.array([len(b) for b in bufs], np.int32)


def bcj2_lanes(datas, encode, *, edge: bool, map_fn=map):
    """BCJ2 streams of ``datas`` (``encode`` is ``ops/filters.bcj2_encode``,
    run through ``map_fn``) as a batch.  With ``edge``, six lanes of lane 0
    follow: an rc stream cut to half, a call stream 4 bytes short, a jump
    stream 4 bytes short, a main stream 1 byte short, an out_size 1 byte
    short (ok, the output cut) and an rc stream of 3 bytes.  Returns (the
    main, call, jump and rc rows, their lengths, out_size int32, the ok
    each lane must give)."""
    lanes = list(map_fn(encode, datas))
    sizes = [len(d) for d in datas]
    ok = [True] * len(datas)
    if edge:
        m, c, j, r = lanes[0]
        lanes += [(m, c, j, r[:len(r) // 2]), (m, c[:-4], j, r),
                  (m, c, j[:-4], r), (m[:-1], c, j, r), (m, c, j, r),
                  (m, c, j, r[:3])]
        sizes += [sizes[0]] * 4 + [sizes[0] - 1, sizes[0]]
        ok += [False] * 4 + [True, False]
    cols = [pad_rows([t[k] for t in lanes]) for k in range(4)]
    return ([a for a, _ in cols], [n for _, n in cols],
            np.array(sizes, np.int32), ok)


def bcj2_past_row_batch(encode):
    """The corpus's BCJ2 lanes with lengths past their rows, so that a lane
    reads its row's last byte for every index past it: the call and jump
    rows cut to half the longest stream, the rc row to 2 bytes short of it
    (lane 3 then fails), lane 0's main length 9 past its row and lane 1's
    rc length tripled."""
    datas = bcj2_corpus()
    (m, c, j, r), lens, out_size, _ = bcj2_lanes(datas, encode,
                                                  edge=False)
    cut = [int(lens[1].max()) // 2, int(lens[2].max()) // 2,
           int(lens[3].max()) - 2]
    streams = [m] + [np.ascontiguousarray(a[:, :w])
                     for a, w in zip((c, j, r), cut)]
    lens[0][0] = m.shape[1] + 9
    lens[3][1] *= 3
    return streams, lens, out_size


def bcj2_site_at_end(encode):
    """Three 256-byte lanes whose main streams fill their 256-byte rows and
    end on an E8, an E9 and a 0F 85 site (no room for a conversion there):
    the JAX batch function's scan never ends on such a row.  Returns
    (streams, lens, out_size, the original lanes)."""
    rng = np.random.default_rng(21)
    datas = []
    for tail in (b"\xe8", b"\xe9", b"\x0f\x85"):
        while True:
            d = rng.integers(0, 256, 256 - len(tail), dtype=np.uint8)
            d = d.tobytes() + tail
            if len(encode(d)[0]) == 256:
                break
        datas.append(d)
    streams, lens, out_size, _ = bcj2_lanes(datas, encode, edge=False)
    return streams, lens, out_size, datas


# ---------------------------------------------------------------------------
# adversarial batches of the segmented kernels (csrc/filters_lane.cuh): x86
# runs a thread from one sync point (4 bytes without E8/E9 before it) to
# the next over tiles of a row, BCJ2 walks a list of candidate sites
# ---------------------------------------------------------------------------

def x86_every3_rows(S, L, seed):
    """[S, L] uint8 rows with an E8 (E9 in odd rows) every 3 bytes, so no
    position past 0 is a sync point; the byte after each holds 00 or FF
    half the time (the machine's 00/FF tests then pass and fail in turn)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 0xE8, (S, L), dtype=np.uint8)
    data[:, 0::3] = 0xE8
    data[1::2, 0::3] = 0xE9
    ff = rng.integers(0, 4, (S, L), dtype=np.uint8)
    data[:, 1::3] = np.where(ff[:, 1::3] == 0, 0,
                             np.where(ff[:, 1::3] == 1, 0xFF,
                                      data[:, 1::3]))
    return data


def x86_every3_batch():
    """Four 600-byte rows of ``x86_every3_rows`` at full ``valid``, one with
    an ip near 2^32."""
    data = x86_every3_rows(4, 600, seed=31)
    valid = np.full(4, 600, np.int32)
    ip = np.array([0, 4096, 0xFFFFFFF0, 7], np.uint32)
    return data, valid, ip


def x86_span_edge_batch(w):
    """Rows built around the multiples of ``w`` (>= 6), the span starts of a
    block whose spans are ``w`` bytes wide: in row 0 a convertible E8 at
    k*w - 4 (its patch covers the start), in row 1 at k*w - 5 (its patch
    ends right before the start, a sync point), in row 2 an E8 at k*w - 1
    (a site just before the start, whose operand bytes follow it), in row 3
    an E9 right at the start after 4 plain bytes (a sync point on a site),
    in row 4 all four mixed by k mod 4 (with FF operands), in row 5 the
    same with dense E8 runs that the prev-mask skips.  Other bytes are
    random and never E8/E9."""
    L = 40 * w + 3
    rng = np.random.default_rng(w)
    data = rng.integers(0, 0xE8, (6, L), dtype=np.uint8)
    for k in range(1, L // w):
        s = k * w
        data[0, s - 4:s + 1] = [0xE8, 0, 0, 0, 0]
        data[1, s - 5:s] = [0xE8, 0, 0, 0, 0]
        data[2, s - 1] = 0xE8
        data[2, s + 3] = 0
        data[3, s:s + 5] = [0xE9, 0, 0, 0, 0]
        off = (-4, -5, -1, 0)[k % 4]
        data[4, s + off] = 0xE8
        data[4, s + off + 1:s + off + 5] = 0xFF
        data[5, s + off:s + off + 3] = 0xE8
        data[5, s + off + 3:s + off + 5] = 0
    valid = np.array([L, L, L, L - 2, L, L], np.int32)
    ip = np.array([0, 12, 0xFFFFFFF8, 1 << 31, 5, 0xFFFFFFFF], np.uint32)
    return data, valid, ip


def x86_tail_batch():
    """Sites in the last 8 bytes of 64-byte rows at every ``valid`` around
    the row's end (0, 4, 5, L, L + 4, L + 5 and 2 L): four endings, each at
    the seven lengths, ip near 2^32 in half of them.  Only a valid past
    L + 3 reaches the JAX function's clamped steps at the row's end."""
    L = 64
    ends = ([0xE8, 0, 0, 0, 0, 0xE8, 0xFF, 0xFF],
            [0x11, 0xE9, 0xFF, 0xFF, 0xFF, 0xFF, 0x22, 0xE8],
            [0xE8, 0xE8, 0, 0, 0xE9, 0, 0, 0],
            [0x33, 0x44, 0x55, 0xE8, 0, 0, 0, 0xFF])
    lens = (0, 4, 5, L, L + 4, L + 5, 2 * L)
    rng = np.random.default_rng(41)
    data = rng.integers(0, 256, (len(ends) * len(lens), L), dtype=np.uint8)
    data[:, ::9] = 0xE8
    for r, end in enumerate(ends):
        data[r * len(lens):(r + 1) * len(lens), L - 8:] = end
    valid = np.array(lens * len(ends), np.int32)
    ip = np.array([0xFFFFFFFC if r % 2 else 0x100 * r
                   for r in range(len(valid))], np.uint32)
    return data, valid, ip


def bcj2_encode_mixed(data: bytes) -> tuple[bytes, bytes, bytes, bytes]:
    """BCJ2 streams of ``data`` that convert every site with 4 bytes after
    it whose top byte is 0F, and two in three of the others by a hash of
    the position (``ops/filters.bcj2_encode`` converts only 00/FF tops, so
    its streams never put 0F in the decoder's prev after a conversion).
    The range coder is the LZMA one, as there."""
    M32 = 0xFFFFFFFF
    main, call, jump, rc = bytearray(), bytearray(), bytearray(), bytearray()
    probs = [1024] * 258
    st = {"low": 0, "rng": M32, "cache": 0, "size": 1}

    def shift_low():
        low = st["low"]
        if low < 0xFF000000 or low > M32:
            carry = low >> 32
            rc.append((st["cache"] + carry) & 0xFF)
            rc.extend(bytes([(0xFF + carry) & 0xFF]) * (st["size"] - 1))
            st["cache"], st["size"] = (low >> 24) & 0xFF, 0
        st["size"] += 1
        st["low"] = (low & 0x00FFFFFF) << 8

    def bit(i, b):
        p = probs[i]
        bound = (st["rng"] >> 11) * p
        if b:
            st["low"] += bound
            st["rng"] -= bound
            probs[i] = p - (p >> 5)
        else:
            st["rng"] = bound
            probs[i] = p + ((2048 - p) >> 5)
        while st["rng"] < 1 << 24:
            st["rng"] = (st["rng"] << 8) & M32
            shift_low()

    i, prev, n = 0, 0, len(data)
    while i < n:
        b = data[i]
        main.append(b)
        i += 1
        site = (b & 0xFE) == 0xE8 or (prev == 0x0F and (b & 0xF0) == 0x80)
        pidx = 2 + prev if b == 0xE8 else 0 if b == 0xE9 else 1
        if site and i + 4 <= n and (data[i + 3] == 0x0F
                                    or (i * 0x9E3779B1 >> 20) % 3):
            bit(pidx, 1)
            dest = (int.from_bytes(data[i:i + 4], "little") + i + 4) & M32
            (call if b == 0xE8 else jump).extend(dest.to_bytes(4, "big"))
            prev = data[i + 3]
            i += 4
            continue
        if site and i < n:
            bit(pidx, 0)
        prev = b
    for _ in range(5):
        shift_low()
    return bytes(main), bytes(call), bytes(jump), bytes(rc)


def bcj2_every_data(n, seed):
    """``n`` bytes with call, jump and Jcc sites whose rel32 ends in 0F and
    is followed by an E8, an E9, a Jcc or a 0F 8x pair: every kind of site
    that takes the decoder's prev from a converted site's top byte."""
    rng = np.random.default_rng(seed)
    d = bytearray(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    tails = (b"\xe8", b"\xe9", b"\x85", b"\x0f\x84", b"\x8f")
    for off in range(0, n - 16, 11):
        head = (b"\xe8", b"\xe9", b"\x0f\x85")[(off // 11) % 3]
        rel = bytes(rng.integers(0, 256, 3, dtype=np.uint8)) + b"\x0f"
        d[off:off + 10] = (head + rel + tails[(off // 33) % 5]).ljust(
            10, b"\x00")[:10]
    return bytes(d)


def bcj2_mixed_batch():
    """BCJ2 lanes of ``bcj2_encode_mixed`` over ``bcj2_every_data``: three
    whole lanes, then lane 0 with the output cut mid-stream (at half, right
    before the site byte at 33, right after it, and 1 and 3 bytes into its
    rel32, which then reaches past out_size), its call and jump streams
    running out (cut by 4 and to nothing), its rc stream at 0, 3 and 4
    bytes, and one lane whose main stream ends on an E8 in its row's last
    byte.  Returns (the main, call, jump and rc rows, their lengths,
    out_size int32, the original lanes; lanes 0-2 must decode to them)."""
    datas = [bcj2_every_data(2000 + 137 * s, seed=50 + s) for s in range(3)]
    lanes = [bcj2_encode_mixed(d) for d in datas]
    m, c, j, r = lanes[0]
    n0 = len(datas[0])
    sizes = [len(d) for d in datas]
    extra = [((m, c, j, r), n) for n in (n0 // 2, 33, 34, 35, 37)]
    extra += [((m, c[:-4], j, r), n0), ((m, b"", j, r), n0),
              ((m, c, j[:-4], r), n0), ((m, c, b"", r), n0),
              ((m, c, j, b""), n0), ((m, c, j, r[:3]), n0),
              ((m, c, j, r[:4]), n0)]
    tail = datas[2] + b"\xe8"        # the longest main stream
    extra.append((bcj2_encode_mixed(tail), len(tail)))
    lanes += [x for x, _ in extra]
    sizes += [n for _, n in extra]
    cols = [pad_rows([t[k] for t in lanes]) for k in range(4)]
    arrs, lens = [a for a, _ in cols], [n for _, n in cols]
    # the last lane's main stream, the longest, ends on its E8 at the end
    # of the main rows
    arrs[0] = np.ascontiguousarray(arrs[0][:, :int(lens[0].max())])
    assert arrs[0][-1, -1] == 0xE8 and lens[0][-1] == arrs[0].shape[1]
    return arrs, lens, np.array(sizes, np.int32), datas
