"""The port's device CRC32/CRC64 X3 against the JAX package's and the hosts'.

At the sizes of tests/test_checksum_device.py, with data from a seed and
init values 0 and non-zero, ``crc*_device(device="cpu")`` (the plain
versions) must equal the JAX package's ``crc*_device`` and the host's
``binascii.crc32`` / ``native.crc64``.  The block step and tree join of
``csrc/checksum_lane.cuh``, built for the CPU by the harness, must equal
the plain block states and combine; on a card, so must the kernels.
"""

from __future__ import annotations

import binascii
import ctypes
import importlib.util
import os

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
# the kernels' own block source, built for the CPU, against the plain version
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
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lzt_crc_blocks_cpu.restype = ctypes.c_int
    lib.lzt_crc_blocks_cpu.argtypes = [P, L, I, P]
    lib.lzt_crc_combine_cpu.restype = ctypes.c_int
    lib.lzt_crc_combine_cpu.argtypes = [P, L, P, I, P]
    return lib


@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("n", [1, 65, 4097])
def test_harness_matches_plain(harness, width, n):
    buf, _ = C.prep(_data(n))
    t = torch.from_numpy(buf)
    plain = C.block_states_plain(t, width)
    lanes = len(buf) // C.BLOCK
    states = torch.zeros(lanes, dtype=torch.int64)
    assert harness.lzt_crc_blocks_cpu(t.data_ptr(), lanes, width,
                                      states.data_ptr()) == 0
    assert torch.equal(states, plain)
    levels = lanes.bit_length() - 1
    mats = np.ascontiguousarray(C.level_matrices(width, levels))
    out = ctypes.c_uint64(0)
    assert harness.lzt_crc_combine_cpu(
        states.data_ptr(), lanes, mats.ctypes.data, width,
        ctypes.addressof(out)) == 0
    assert out.value == C.combine_plain(plain, width)


def test_device_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(UnsupportedError):
        C.crc32_device(b"abc")


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for n in CRC64_SIZES + (1 << 20,):
        d = _data(n)
        buf, _ = C.prep(d)
        for width in (32, 64):
            t = torch.from_numpy(buf)
            kern = C.crc_blocks(t.cuda(), width)
            assert torch.equal(kern.cpu(), C.block_states_plain(t, width))
        assert C.crc32_device(d, INIT32) == binascii.crc32(d, INIT32)
        assert C.crc64_device(d, INIT64) == native.crc64(d, INIT64)
