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
