"""The port's device CRC32/CRC64 X3 against the JAX package's and the hosts'.

At the sizes of tests/test_checksum_device.py, with data from a seed and
init values 0 and non-zero, ``crc*_device(device="cpu")`` (the plain
versions) must equal the JAX package's ``crc*_device`` and the host's
``binascii.crc32`` / ``native.crc64``.  The kernels' own source
(``csrc/checksum_lane.cuh``), built for the CPU by the harness, plays the
kernels' schedule -- a tile's segments, the warp tree in shuffle order, the
warps' join, the short last tile staged right-aligned, the per-piece
launches and the fold -- at small tiles (256 B, 4 KiB) and at the real one;
at every length of ``_lengths`` its tile states and fold must equal the
plain versions, and its CRCs the hosts' (tolerance 0: integer programs).
On a card, so must the kernels.
"""

from __future__ import annotations

import binascii
import ctypes
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from lzma_sdk_zliblike_tpu.ops import checksum as JC
from lzma_sdk_zliblike_tpu_torch import native
from lzma_sdk_zliblike_tpu_torch.ops import checksum as C
from lzma_sdk_zliblike_tpu_torch.utils.errors import UnsupportedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRC32_SIZES = (0, 1, 7, 63, 64, 65, 1000, 65536)
CRC64_SIZES = (0, 1, 7, 64, 100, 4096, 100001)
INIT32, INIT64 = 0xABCDEF, 0x123456789A
INITS = {32: INIT32, 64: INIT64}
HOST = {32: binascii.crc32, 64: native.crc64}
JAX = {32: JC.crc32_device, 64: JC.crc64_device}
ONES = {32: 0xFFFFFFFF, 64: (1 << 64) - 1}


def _data(n: int) -> bytes:
    return np.random.default_rng(n + 17).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n", CRC32_SIZES)
def test_crc32_matches_jax_and_binascii(n):
    d = _data(n)
    for value in (0, INIT32):
        want = binascii.crc32(d, value)
        assert C.crc32_plain(d, value) == want, (n, value)
        assert C.crc32_device(d, value, device="cpu") == want
        assert JC.crc32_device(d, value) == want


@pytest.mark.parametrize("n", CRC64_SIZES)
def test_crc64_matches_jax_and_native(n):
    d = _data(n)
    for value in (0, INIT64):
        want = native.crc64(d, value)
        assert C.crc64_plain(d, value) == want, (n, value)
        assert JC.crc64_device(d, value) == want


def test_rolling_crc_chains():
    d = _data(5000)
    assert C.crc32_plain(d[3000:], C.crc32_plain(d[:3000])) == \
        binascii.crc32(d)
    assert C.crc64_plain(d[3000:], C.crc64_plain(d[:3000])) == native.crc64(d)


# ---------------------------------------------------------------------------
# the kernels' own source, built for the CPU, against the plain versions
# ---------------------------------------------------------------------------

def _load(name, file):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def harness():
    lib = _load("lzt_torch_cpu_harness", "torch_cpu_harness.py").build()
    if lib is None:
        pytest.skip("g++ not available")
    P, I, L, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_ulonglong)
    for name, args in (("lzt_crc_init_cpu", [I, P]),
                       ("lzt_crc_tiles_cpu", [P, L, I, I, I, P, P]),
                       ("lzt_crc_fold_cpu", [P, L, I, I, I, U, P, P]),
                       ("lzt_crc_call_cpu", [P, L, I, U, I, I, L, I, P, P])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, args
    return lib


def _consts(lib, width):
    c = np.zeros(C.TABLE_WORDS + C.POWERS * width,
                 np.uint64 if width == 64 else np.uint32)
    assert lib.lzt_crc_init_cpu(width, c.ctypes.data) == 0
    return c


def _tiles(lib, d: bytes, width, tile, threads, consts, n=None):
    """The harness's tile states of the first n bytes of d (all of d)."""
    n = len(d) if n is None else n
    buf = np.frombuffer(d, np.uint8) if n else np.zeros(1, np.uint8)
    out = np.zeros(-(-n // tile), np.uint64)
    assert lib.lzt_crc_tiles_cpu(buf.ctypes.data, n, width, tile, threads,
                                 consts.ctypes.data, out.ctypes.data) == 0
    return out


def _fold(lib, states, n, width, value, tile, fold_threads, consts):
    st = np.ascontiguousarray(states, np.uint64)
    out = ctypes.c_uint64(0)
    assert lib.lzt_crc_fold_cpu(st.ctypes.data, n, width, tile, fold_threads,
                                (value ^ ONES[width]) & ONES[width],
                                consts.ctypes.data,
                                ctypes.addressof(out)) == 0
    return out.value


def _call(lib, d: bytes, width, value, cfg, consts):
    tile, threads, piece, fold_threads = cfg
    buf = np.frombuffer(d, np.uint8) if d else np.zeros(1, np.uint8)
    out = ctypes.c_uint64(0)
    assert lib.lzt_crc_call_cpu(buf.ctypes.data, len(d), width, value, tile,
                                threads, piece, fold_threads,
                                consts.ctypes.data,
                                ctypes.addressof(out)) == 0
    return out.value


# (tile, threads a tile, piece, fold threads): two small tiles, whose
# segments are 16 and 64 bytes and whose folds run many leaves a thread,
# and the kernels' own geometry (csrc/checksum.cu, ops/checksum.py)
CONFIGS = {"tile256": (256, 16, 1024, 4), "tile4k": (4096, 64, 16384, 16),
           "real": (C.TILE, 256, C.PIECE, 256)}


def _lengths(tile, piece):
    return sorted({0, 1, 15, 16, 17, 255, 256, 257, tile - 1, tile, tile + 1,
                   3 * tile + 5, 100001, piece - 1, piece, piece + 1})


CASES = [pytest.param(name, n, id=f"{name}-{n}")
         for name, cfg in CONFIGS.items() for n in _lengths(cfg[0], cfg[2])]


@pytest.mark.parametrize("name,n", CASES)
def test_harness_matches_plain(harness, name, n):
    """Both widths, both init values and a rolling CRC: the harness's
    schedule == the hosts' CRCs; its tile states == ``tile_states_plain``;
    its fold == ``fold_plain``; at the real geometry ``crc*_device`` on the
    CPU == the hosts' and, below the piece size, == the JAX package's."""
    cfg = CONFIGS[name]
    tile, threads, _, fold_threads = cfg
    d = _data(n)
    t = torch.frombuffer(bytearray(d), dtype=torch.uint8) if n else \
        torch.zeros(0, dtype=torch.uint8)
    for width in (32, 64):
        consts = _consts(harness, width)
        plain = C.tile_states_plain(t, n, width, tile)
        if n:
            tiles = _tiles(harness, d, width, tile, threads, consts)
            assert np.array_equal(tiles.view(np.int64), plain.numpy()), \
                (width, n)
        for value in (0, INITS[width]):
            want = HOST[width](d, value)
            assert _call(harness, d, width, value, cfg, consts) == want
            assert C.fold_plain(plain, n, width, value, tile) == want
            if n:
                assert _fold(harness, plain.numpy(), n, width, value, tile,
                             fold_threads, consts) == want
            if name == "real":
                fn = C.crc32_device if width == 32 else C.crc64_device
                assert fn(d, value, device="cpu") == want
                if n < C.PIECE - 1:
                    assert JAX[width](d, value) == want
        k = n // 3
        head = _call(harness, d[:k], width, INITS[width], cfg, consts)
        assert _call(harness, d[k:], width, head, cfg, consts) == \
            HOST[width](d, INITS[width])


def test_harness_tables_and_powers(harness):
    """The init kernel's tables are T_k[b], byte b and k zero bytes fed
    bit by bit; its powers are ``ops/checksum.powers`` (numpy squarings);
    Z^m v through them is m zero bytes fed into v."""
    for width in (32, 64):
        consts = _consts(harness, width).astype(np.uint64)
        poly = C._poly(width)

        def feed(s, bits):
            for _ in range(bits):
                s = (s >> 1) ^ (poly if s & 1 else 0)
            return s

        for k in (0, 1, 7, 15):
            for b in (0, 1, 0x80, 0xA7, 0xFF):
                assert int(consts[k * 256 + b]) == feed(b, 8 * (k + 1))
        assert np.array_equal(consts[C.TABLE_WORDS:].reshape(C.POWERS, width),
                              C.powers(width))
        for m in (0, 1, 5, 64, 1000):
            v = 0x1234567 if width == 32 else 0x123456789ABCDEF
            assert C._zpow_apply(width, m, v) == feed(v, 8 * m)


@pytest.mark.parametrize("extra", range(1, 18))
def test_harness_reads_nothing_past_n(harness, extra):
    """A length 1-17 bytes past a tile boundary: the tile states do not
    depend on the bytes after n (two different tails), and equal the plain
    version's."""
    tile, threads = 256, 16
    n = 4 * tile + extra
    d = _data(n)
    for width in (32, 64):
        consts = _consts(harness, width)
        got = [_tiles(harness, d + bytes([tail]) * 64, width, tile, threads,
                      consts, n) for tail in (0x00, 0xFF)]
        exact = _tiles(harness, d, width, tile, threads, consts)
        assert np.array_equal(got[0], exact) and \
            np.array_equal(got[1], exact)
        plain = C.tile_states_plain(torch.frombuffer(bytearray(d),
                                                     dtype=torch.uint8),
                                    n, width, tile)
        assert np.array_equal(exact.view(np.int64), plain.numpy())


def test_leading_zeros_are_free(harness):
    """state(0^k || M) = state(M): with init all-ones (a zero register)
    leading zero bytes change no CRC, and a short tile's state is the state
    of its own bytes wherever it sits in the tile."""
    m = _data(100)
    for width in (32, 64):
        consts = _consts(harness, width)
        ones = ONES[width]
        for k in (1, 16, 156, 1000):
            z = bytes(k) + m
            assert HOST[width](z, ones) == HOST[width](m, ones)
            fn = C.crc32_plain if width == 32 else C.crc64_plain
            assert fn(z, ones) == fn(m, ones)
            assert _call(harness, z, width, ones, CONFIGS["tile256"],
                         consts) == HOST[width](m, ones)
        short = _tiles(harness, m, width, 256, 16, consts)
        for k in (1, 100, 156):
            assert np.array_equal(
                _tiles(harness, bytes(k) + m, width, 256, 16, consts), short)


def test_wrappers_check_their_arguments():
    t = torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(ValueError):
        C.crc_tiles(t.to(torch.int32), 64)
    with pytest.raises(ValueError):
        C.crc_tiles(torch.zeros(10, 10, dtype=torch.uint8), 64)
    with pytest.raises(ValueError):
        C.crc_tiles(torch.zeros(200, dtype=torch.uint8)[::2], 64)
    with pytest.raises(ValueError):
        C.crc_tiles(t, 16)
    with pytest.raises(ValueError):
        C.crc_tiles(t, 64, first_tile=1)
    st = C.crc_tiles(t, 64)
    assert st.shape == (1,)
    with pytest.raises(ValueError):
        C.crc_fold(st, C.TILE + 1, 64, 0)      # two tiles need two states
    with pytest.raises(ValueError):
        C.crc_fold(st.to(torch.int32), 100, 64, 0)
    out = torch.zeros(3, dtype=torch.int64)
    assert C.crc_tiles(t, 32, 2, out).data_ptr() == out[2:].data_ptr()
    assert C.crc_fold(out[2:], 100, 32, 7) == binascii.crc32(bytes(100), 7)


def test_kernel_geometry_matches_python():
    """TILE and the table and power counts of ops/checksum.py are the
    kernels' (csrc/checksum.cu, csrc/checksum_lane.cuh)."""
    csrc = os.path.join(REPO, "lzma_sdk_zliblike_tpu_torch", "csrc")
    with open(os.path.join(csrc, "checksum.cu")) as f:
        cu = f.read()
    with open(os.path.join(csrc, "checksum_lane.cuh")) as f:
        cuh = f.read()

    def const(src, name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const(cu, "kThreads")) * int(const(cu, "kSeg")) == C.TILE
    assert 1 << int(const(cu, "kTileLog")) == C.TILE
    assert int(const(cuh, "kSlices")) * 256 == C.TABLE_WORDS
    assert int(const(cuh, "kPowers")) == C.POWERS


def test_device_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(UnsupportedError):
        C.crc32_device(b"abc")


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for n in CRC64_SIZES[1:] + (C.TILE - 1, C.TILE + 1, 3 * C.TILE + 5,
                                C.PIECE + 1):
        d = _data(n)
        t = torch.frombuffer(bytearray(d), dtype=torch.uint8)
        for width in (32, 64):
            kern = C.crc_tiles(t.cuda(), width)
            plain = C.tile_states_plain(t, n, width)
            assert torch.equal(kern.cpu(), plain)
            value = INITS[width]
            assert C.crc_fold(kern, n, width, value) == \
                C.fold_plain(plain, n, width, value) == HOST[width](d, value)
        assert C.crc32_device(d, INIT32) == binascii.crc32(d, INIT32)
        assert C.crc64_device(d, INIT64) == native.crc64(d, INIT64)
